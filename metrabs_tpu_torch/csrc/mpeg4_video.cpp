// MPEG-4 Part 2 video (ISO/IEC 14496-2; the `mp4v` FourCC that cv2 and
// FFmpeg write, and the Advanced Simple streams Xvid writes) on the host: a
// decoder whose planes equal FFmpeg's (libavcodec's mpeg4 decoder) bit for
// bit, and a Simple Profile encoder whose reconstruction is the decoder's
// own.
//
// Decoder. Rectangular 8-bit 4:2:0 video:
// - I-, P-, B- and S-VOPs. DC/AC prediction with the alternate scans, intra
//   DC through the DC size VLCs or (intra_dc_vlc_thr) the AC table, dquant
//   and dbquant, not-coded MBs, intra MBs in P- and S-VOPs, 1MV and 4MV with
//   median prediction and f_code wrap, unrestricted MVs over references
//   replicated past the edge of the MB-aligned picture (FFmpeg pads from
//   mb_width * 16, not the display width), resync markers and video
//   packets, not-coded VOPs.
// - B-VOPs: forward, backward, interpolated and direct modes (the
//   co-located MB's 1MV, 4MV or field vectors scaled by TRB / TRD from the
//   VOP times, modulo_time_base wraps included), a B-MB skipped where the
//   co-located MB was not coded, fcode_backward, and FFmpeg's skipping of a
//   B-VOP without two anchors or out of order (an open GOP after a seek).
// - Output order as FFmpeg's decoder gives it: with low_delay 0 an anchor
//   comes out when the next one is decoded and the last at the flush; a
//   not-coded VOP gives no frame, but a final one gives the last frame
//   again (FFmpeg's skipped_last_frame); a packed bitstream (DivX 5's
//   convention, which Xvid's XVID_GLOBAL_PACKED writes, stamped
//   "DivX<ver>b<build>p") has its second VOP decoded with the next packet,
//   whose placeholder is dropped.
// - MPEG quantisation (quant_type 1): the default matrices or loaded ones
//   (zigzag order, to the end-of-matrix zero), FFmpeg's dequantisation
//   (the intra DC by the DC scaler, mismatch control on inter blocks only).
// - Quarter-pel MC with FFmpeg's MPEG-4 filters (mirrored at the block's
//   edges; 8x8 blocks for 4MV and for direct mode's vectors) and its chroma
//   vectors; FFmpeg's QPEL_CHROMA workarounds belong to the refused builds.
// - GMC (sprite_enable 2) of three warping points, as Xvid writes it: the
//   sprite trajectory, FFmpeg's one-point path where the warp is a
//   translation and its general path else, mcsel per MB, the average MV of
//   a GMC MB for its neighbours and for direct mode.
// - Interlaced coding: field DCT, field MVs in P- and B-VOPs with their
//   field selects and the chroma rounding of field vectors, field direct
//   mode, top_field_first and alternate_vertical_scan_flag; a frame is the
//   two fields woven, as FFmpeg outputs it (no deinterlacing).
// Half-pel MC honours vop_rounding_type (B-VOPs round). The decisions
// FFmpeg takes where the standard leaves room are taken as it takes them:
// the DC clip to [0, 2047], the AC rescale by the neighbour's qscale, the AC
// buffers cleared at a video packet, the MV prediction at a packet's first
// line. The IDCT is FFmpeg's C "simple IDCT" (integer rows, then columns,
// with 11- and 20-bit shifts and the DC-only row shortcut), which FFmpeg
// uses for Lavc-stamped and unstamped streams; a stream whose user data
// carries an Xvid stamp ("XviD<build>", read as FFmpeg's decode_user_data
// reads it) is decoded with FFmpeg's Xvid IDCT (ff_xvid_idct: 16-bit rows
// with per-row rounding, then columns through the tangent butterflies), as
// FFmpeg switches to it, whatever DivX stamp stands beside it. FFmpeg also
// takes an unstamped stream in an AVI with the FourCC XVID (XVIX, RMP4,
// ZMP4, SIPP) for Xvid build 0, and DivX-stamped or unstamped DIVX streams
// for DivX: both then get bug workarounds (edge emulation, DC clipping,
// half-pel and quarter-pel chroma rounding, the direct-mode block size)
// that this decoder does not emulate, so they are refused, as Xvid builds
// up to 32 are.
//
// Every other tool raises "unsupported" naming it: static sprites, sprite
// brightness change, GMC of other than 3 warping points, data partitioning
// and RVLC, non-rectangular shape, not-8-bit, reduced resolution VOPs,
// newpred, scalability and complexity estimation.
//
// Encoder. I-VOP every `gop` frames, P-VOPs between, at a fixed quantiser,
// 1MV with a predictor search and half-pel refinement, intra MBs where they
// cost less, not-coded MBs, vop_rounding_type flipped on each P-VOP as
// FFmpeg flips it. Headers: VOS (Simple Profile), VO, VOL (verid 1,
// low_delay), GOV before each I-VOP. Optional tools (Tools), off as in cv2's
// stream: AC prediction, dquant, 4MV, video packets, intra_dc_vlc_thr and
// not-coded VOPs; FFmpeg decodes each of them to the encoder's
// reconstruction.
//
// C interface for ctypes; a call returns 0, 1 (corrupt stream), 2
// (unsupported tool, named in the error text) or 3 (a packet without a VOP).

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "yuv_rgb.h"

namespace {

enum { kOk = 0, kCorrupt = 1, kUnsupported = 2, kNoFrame = 3 };

struct Failure {
  int code;
  std::string message;
};

[[noreturn]] void corrupt(const char* fmt, ...) {
  char buf[200];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Failure{kCorrupt, buf};
}

[[noreturn]] void unsupported(const char* tool) { throw Failure{kUnsupported, tool}; }

inline uint8_t clip_pixel(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

inline int log2_floor(unsigned v) {
  int n = 0;
  while (v >>= 1) n++;
  return n;
}

// ---------------------------------------------------------------------------
// Tables (ISO/IEC 14496-2 Annex B; the TCOEF tables as FFmpeg orders them)

// MCBPC of I-VOPs: symbols 0-3 intra with cbpc, 4-7 intra+q, 8 stuffing.
const uint8_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                   {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// MCBPC of P-VOPs: bit 2 intra, bit 3 dquant, bit 4 4MV; 20 stuffing.
const uint8_t kInterMcbpc[21][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6},  // inter
    {3, 5}, {4, 8}, {3, 8}, {3, 7},  // intra
    {3, 3}, {7, 7}, {6, 7}, {5, 9},  // inter + q
    {4, 6}, {4, 9}, {3, 9}, {2, 9},  // intra + q
    {2, 3}, {5, 7}, {4, 7}, {5, 8},  // inter 4MV
    {1, 9}};                         // stuffing
// CBPY as intra MBs read it (inter MBs invert it).
const uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                              {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                              {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Motion vector differences by |motion_code|; a sign bit follows.
const uint8_t kMv[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},   {11, 9},
    {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},
    {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
// dct_dc_size VLCs.
const uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                               {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5}, {1, 6},
                                 {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// TCOEF: (code, length) of each (last, run, level); the last entry is ESCAPE.
const uint16_t kIntraVlc[103][2] = {
    {0x2, 2}, {0x6, 3}, {0xf, 4}, {0xd, 5}, {0xc, 5}, {0x15, 6}, {0x13, 6}, {0x12, 6},
    {0x17, 7}, {0x1f, 8}, {0x1e, 8}, {0x1d, 8}, {0x25, 9}, {0x24, 9}, {0x23, 9}, {0x21, 9},
    {0x21, 10}, {0x20, 10}, {0xf, 10}, {0xe, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4}, {0x14, 6}, {0x16, 7}, {0x1c, 8}, {0x20, 9},
    {0x1f, 9}, {0xd, 10}, {0x22, 11}, {0x53, 12}, {0x55, 12}, {0xb, 5}, {0x15, 7}, {0x1e, 9},
    {0xc, 10}, {0x56, 12}, {0x11, 6}, {0x1b, 8}, {0x1d, 9}, {0xb, 10}, {0x10, 6}, {0x22, 9},
    {0xa, 10}, {0xd, 6}, {0x1c, 9}, {0x8, 10}, {0x12, 7}, {0x1b, 9}, {0x54, 12}, {0x14, 7},
    {0x1a, 9}, {0x57, 12}, {0x19, 8}, {0x9, 10}, {0x18, 8}, {0x23, 11}, {0x17, 8}, {0x19, 9},
    {0x18, 9}, {0x7, 10}, {0x58, 12}, {0x7, 4}, {0xc, 6}, {0x16, 8}, {0x17, 9}, {0x6, 10},
    {0x5, 11}, {0x4, 11}, {0x59, 12}, {0xf, 6}, {0x16, 9}, {0x5, 10}, {0xe, 6}, {0x4, 10},
    {0x11, 7}, {0x24, 11}, {0x10, 7}, {0x25, 11}, {0x13, 7}, {0x5a, 12}, {0x15, 8}, {0x5b, 12},
    {0x14, 8}, {0x13, 8}, {0x1a, 8}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7},
};
const uint16_t kInterVlc[103][2] = {
    {0x2, 2}, {0xf, 4}, {0x15, 6}, {0x17, 7}, {0x1f, 8}, {0x25, 9}, {0x24, 9}, {0x21, 10},
    {0x20, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x6, 3}, {0x14, 6}, {0x1e, 8}, {0xf, 10},
    {0x21, 11}, {0x50, 12}, {0xe, 4}, {0x1d, 8}, {0xe, 10}, {0x51, 12}, {0xd, 5}, {0x23, 9},
    {0xd, 10}, {0xc, 5}, {0x22, 9}, {0x52, 12}, {0xb, 5}, {0xc, 10}, {0x53, 12}, {0x13, 6},
    {0xb, 10}, {0x54, 12}, {0x12, 6}, {0xa, 10}, {0x11, 6}, {0x9, 10}, {0x10, 6}, {0x8, 10},
    {0x16, 7}, {0x55, 12}, {0x15, 7}, {0x14, 7}, {0x1c, 8}, {0x1b, 8}, {0x21, 9}, {0x20, 9},
    {0x1f, 9}, {0x1e, 9}, {0x1d, 9}, {0x1c, 9}, {0x1b, 9}, {0x1a, 9}, {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4}, {0x19, 9}, {0x5, 11}, {0xf, 6}, {0x4, 11}, {0xe, 6},
    {0xd, 6}, {0xc, 6}, {0x13, 7}, {0x12, 7}, {0x11, 7}, {0x10, 7}, {0x1a, 8}, {0x19, 8},
    {0x18, 8}, {0x17, 8}, {0x16, 8}, {0x15, 8}, {0x14, 8}, {0x13, 8}, {0x18, 9}, {0x17, 9},
    {0x16, 9}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9}, {0x7, 10}, {0x6, 10},
    {0x5, 10}, {0x4, 10}, {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12},
    {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7},
};
// The largest level of each run, in table order: {last 0}, {last 1}.
const uint8_t kIntraMaxLevels[2][41] = {
    {27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1},
    {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};
const uint8_t kInterMaxLevels[2][41] = {
    {12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kQuantDelta[4] = {-1, -2, 1, 2};

int y_dc_scale(int q) { return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16; }
int c_dc_scale(int q) { return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6; }

// One table of (last, run, level) for TCOEF decoding and encoding.
struct RunLevelTable {
  const uint16_t (*vlc)[2];
  uint8_t last[102], run[102], level[102];
  uint8_t max_level[2][64];  // by run
  uint8_t max_run[2][64];    // by level
  int16_t index[2][64][32];  // (last, run, level) -> symbol, -1 if none

  RunLevelTable(const uint16_t (*codes)[2], const uint8_t (*max_levels)[41]) : vlc(codes) {
    memset(max_level, 0, sizeof max_level);
    memset(max_run, 0, sizeof max_run);
    memset(index, 0xff, sizeof index);
    int k = 0;
    for (int l = 0; l < 2; l++)
      for (int r = 0; r < 41 && max_levels[l][r]; r++)
        for (int lev = 1; lev <= max_levels[l][r]; lev++, k++) {
          last[k] = (uint8_t)l;
          run[k] = (uint8_t)r;
          level[k] = (uint8_t)lev;
          max_level[l][r] = (uint8_t)std::max<int>(max_level[l][r], lev);
          max_run[l][lev] = (uint8_t)std::max<int>(max_run[l][lev], r);
          index[l][r][lev] = (int16_t)k;
        }
  }
};

// A prefix code read through one lookup of `bits` bits.
struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;

  template <typename T>
  Vlc(const T (*table)[2], int n, int max_bits) : bits(max_bits) {
    sym.assign(1u << bits, -1);
    len.assign(1u << bits, 0);
    for (int s = 0; s < n; s++) {
      int l = table[s][1];
      if (!l) continue;
      unsigned first = (unsigned)table[s][0] << (bits - l);
      for (unsigned j = 0; j < (1u << (bits - l)); j++) {
        sym[first + j] = (int16_t)s;
        len[first + j] = (uint8_t)l;
      }
    }
  }
};

struct Tables {
  RunLevelTable intra{kIntraVlc, kIntraMaxLevels}, inter{kInterVlc, kInterMaxLevels};
  Vlc intra_vlc{kIntraVlc, 103, 12}, inter_vlc{kInterVlc, 103, 12};
  Vlc intra_mcbpc{kIntraMcbpc, 9, 9}, inter_mcbpc{kInterMcbpc, 21, 9};
  Vlc cbpy{kCbpy, 16, 6}, mv{kMv, 33, 12};
  Vlc dc_lum{kDcLum, 13, 11}, dc_chrom{kDcChrom, 13, 12};
};

const Tables& tables() {
  static const Tables t;  // initialised once, thread-safe
  return t;
}

// ---------------------------------------------------------------------------
// Bit reader (MSB first) over a copy of the packet padded with zero bytes.

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t n) : buf_(n + 8, 0), size_bits_(n * 8) {
    if (n) memcpy(buf_.data(), data, n);
  }
  uint32_t peek(int n) const {  // 1 <= n <= 32
    uint64_t v = 0;
    size_t byte = pos_ >> 3;
    if (byte < buf_.size() - 8) {
      for (int i = 0; i < 8; i++) v = (v << 8) | buf_[byte + i];
    }
    v <<= (pos_ & 7);
    return (uint32_t)(v >> (64 - n));
  }
  uint32_t peek_at(size_t pos, int n) const {  // 1 <= n <= 32, ahead of pos()
    size_t keep = pos_;
    const_cast<BitReader*>(this)->pos_ = pos;
    uint32_t v = peek(n);
    const_cast<BitReader*>(this)->pos_ = keep;
    return v;
  }
  void skip(int n) { pos_ += n; }
  uint32_t get(int n) {
    if (!n) return 0;
    uint32_t v = peek(n);
    pos_ += n;
    return v;
  }
  int get1() { return (int)get(1); }
  int sget(int n) {  // two's complement
    int v = (int)get(n);
    return v >= (1 << (n - 1)) ? v - (1 << n) : v;
  }
  void marker(const char* where) {
    if (!get1()) corrupt("missing marker bit %s", where);
  }
  int vlc(const Vlc& t) {
    uint32_t v = peek(t.bits);
    int l = t.len[v];
    if (!l) corrupt("invalid VLC code at bit %zu", pos_);
    pos_ += l;
    return t.sym[v];
  }
  size_t pos() const { return pos_; }
  void seek(size_t p) { pos_ = p; }
  size_t size_bits() const { return size_bits_; }
  ptrdiff_t left() const { return (ptrdiff_t)size_bits_ - (ptrdiff_t)pos_; }
  void align() { pos_ = (pos_ + 7) & ~size_t(7); }
  const uint8_t* data() const { return buf_.data(); }

 private:
  std::vector<uint8_t> buf_;
  size_t size_bits_;
  size_t pos_ = 0;
};

// ---------------------------------------------------------------------------
// IDCT: FFmpeg's simple IDCT (8-bit), rows then columns.

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20, DC_SHIFT = 3;

void idct_row(int16_t* row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    int16_t v = (int16_t)(uint16_t)(row[0] * (1 << DC_SHIFT));
    for (int i = 0; i < 8; i++) row[i] = v;
    return;
  }
  unsigned a0 = (unsigned)(W4 * row[0]) + (1u << (ROW_SHIFT - 1));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += (unsigned)(W2 * row[2]);
  a1 += (unsigned)(W6 * row[2]);
  a2 -= (unsigned)(W6 * row[2]);
  a3 -= (unsigned)(W2 * row[2]);
  unsigned b0 = (unsigned)(W1 * row[1]) + (unsigned)(W3 * row[3]);
  unsigned b1 = (unsigned)(W3 * row[1]) - (unsigned)(W7 * row[3]);
  unsigned b2 = (unsigned)(W5 * row[1]) - (unsigned)(W1 * row[3]);
  unsigned b3 = (unsigned)(W7 * row[1]) - (unsigned)(W5 * row[3]);
  if (row[4] | row[5] | row[6] | row[7]) {
    a0 += (unsigned)(W4 * row[4]) + (unsigned)(W6 * row[6]);
    a1 += (unsigned)(-W4 * row[4]) - (unsigned)(W2 * row[6]);
    a2 += (unsigned)(-W4 * row[4]) + (unsigned)(W2 * row[6]);
    a3 += (unsigned)(W4 * row[4]) - (unsigned)(W6 * row[6]);
    b0 += (unsigned)(W5 * row[5]) + (unsigned)(W7 * row[7]);
    b1 += (unsigned)(-W1 * row[5]) - (unsigned)(W5 * row[7]);
    b2 += (unsigned)(W7 * row[5]) + (unsigned)(W3 * row[7]);
    b3 += (unsigned)(W3 * row[5]) - (unsigned)(W1 * row[7]);
  }
  row[0] = (int16_t)((int)(a0 + b0) >> ROW_SHIFT);
  row[7] = (int16_t)((int)(a0 - b0) >> ROW_SHIFT);
  row[1] = (int16_t)((int)(a1 + b1) >> ROW_SHIFT);
  row[6] = (int16_t)((int)(a1 - b1) >> ROW_SHIFT);
  row[2] = (int16_t)((int)(a2 + b2) >> ROW_SHIFT);
  row[5] = (int16_t)((int)(a2 - b2) >> ROW_SHIFT);
  row[3] = (int16_t)((int)(a3 + b3) >> ROW_SHIFT);
  row[4] = (int16_t)((int)(a3 - b3) >> ROW_SHIFT);
}

// The column pass of block column `c` (stride 8), pre-clip values out[8].
void idct_col(const int16_t* col, int* out) {
  unsigned a0 = (unsigned)(W4 * (col[0] + ((1 << (COL_SHIFT - 1)) / W4)));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += (unsigned)(W2 * col[16]);
  a1 += (unsigned)(W6 * col[16]);
  a2 += (unsigned)(-W6 * col[16]);
  a3 += (unsigned)(-W2 * col[16]);
  unsigned b0 = (unsigned)(W1 * col[8]), b1 = (unsigned)(W3 * col[8]);
  unsigned b2 = (unsigned)(W5 * col[8]), b3 = (unsigned)(W7 * col[8]);
  b0 += (unsigned)(W3 * col[24]);
  b1 += (unsigned)(-W7 * col[24]);
  b2 += (unsigned)(-W1 * col[24]);
  b3 += (unsigned)(-W5 * col[24]);
  if (col[32]) {
    a0 += (unsigned)(W4 * col[32]);
    a1 += (unsigned)(-W4 * col[32]);
    a2 += (unsigned)(-W4 * col[32]);
    a3 += (unsigned)(W4 * col[32]);
  }
  if (col[40]) {
    b0 += (unsigned)(W5 * col[40]);
    b1 += (unsigned)(-W1 * col[40]);
    b2 += (unsigned)(W7 * col[40]);
    b3 += (unsigned)(W3 * col[40]);
  }
  if (col[48]) {
    a0 += (unsigned)(W6 * col[48]);
    a1 += (unsigned)(-W2 * col[48]);
    a2 += (unsigned)(W2 * col[48]);
    a3 += (unsigned)(-W6 * col[48]);
  }
  if (col[56]) {
    b0 += (unsigned)(W7 * col[56]);
    b1 += (unsigned)(-W5 * col[56]);
    b2 += (unsigned)(W3 * col[56]);
    b3 += (unsigned)(-W1 * col[56]);
  }
  out[0] = (int)(a0 + b0) >> COL_SHIFT;
  out[1] = (int)(a1 + b1) >> COL_SHIFT;
  out[2] = (int)(a2 + b2) >> COL_SHIFT;
  out[3] = (int)(a3 + b3) >> COL_SHIFT;
  out[4] = (int)(a3 - b3) >> COL_SHIFT;
  out[5] = (int)(a2 - b2) >> COL_SHIFT;
  out[6] = (int)(a1 - b1) >> COL_SHIFT;
  out[7] = (int)(a0 - b0) >> COL_SHIFT;
}

// The residual of a block of coefficients (natural order), res[y * 8 + x].
void idct(const int16_t* coef, int* res) {
  int16_t b[64];
  memcpy(b, coef, sizeof b);
  for (int i = 0; i < 8; i++) idct_row(b + 8 * i);
  int out[8];
  for (int c = 0; c < 8; c++) {
    idct_col(b + c, out);
    for (int r = 0; r < 8; r++) res[r * 8 + c] = out[r];
  }
}

void block_idct(const int16_t* coef, int* res, bool xvid);

void idct_put(const int16_t* coef, uint8_t* dst, int stride, bool xvid = false) {
  int res[64];
  block_idct(coef, res, xvid);
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) dst[y * stride + x] = clip_pixel(res[y * 8 + x]);
}

void idct_add(const int16_t* coef, uint8_t* dst, int stride, bool xvid = false) {
  int res[64];
  block_idct(coef, res, xvid);
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) dst[y * stride + x] = clip_pixel(dst[y * stride + x] + res[y * 8 + x]);
}

// ---------------------------------------------------------------------------
// IDCT: FFmpeg's Xvid IDCT (ff_xvid_idct), for Xvid-stamped streams.

const int kXvidTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
const int kXvidTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
const int kXvidTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
const int kXvidTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};
constexpr int XVID_ROW_SHIFT = 11, XVID_COL_SHIFT = 6;
constexpr unsigned XVID_TAN1 = 0x32EC, XVID_TAN2 = 0x6A0A, XVID_TAN3 = 0xAB0E, XVID_SQRT2 = 0x5A82;

// A row; false when it is all zero (left as it is).
bool xvid_idct_row(int16_t* in, const int* tab, int rnd) {
  const unsigned c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3], c5 = tab[4], c6 = tab[5],
                 c7 = tab[6];
  const int right = in[5] | in[6] | in[7];
  const int left = in[1] | in[2] | in[3];
  if (!(right | in[4])) {
    const int k = (int)(c4 * in[0] + rnd);
    if (left) {
      const unsigned a0 = k + c2 * in[2], a1 = k + c6 * in[2], a2 = k - c6 * in[2],
                     a3 = k - c2 * in[2];
      const int b0 = (int)(c1 * in[1] + c3 * in[3]), b1 = (int)(c3 * in[1] - c7 * in[3]);
      const int b2 = (int)(c5 * in[1] - c1 * in[3]), b3 = (int)(c7 * in[1] - c5 * in[3]);
      in[0] = (int16_t)((int)(a0 + b0) >> XVID_ROW_SHIFT);
      in[1] = (int16_t)((int)(a1 + b1) >> XVID_ROW_SHIFT);
      in[2] = (int16_t)((int)(a2 + b2) >> XVID_ROW_SHIFT);
      in[3] = (int16_t)((int)(a3 + b3) >> XVID_ROW_SHIFT);
      in[4] = (int16_t)((int)(a3 - b3) >> XVID_ROW_SHIFT);
      in[5] = (int16_t)((int)(a2 - b2) >> XVID_ROW_SHIFT);
      in[6] = (int16_t)((int)(a1 - b1) >> XVID_ROW_SHIFT);
      in[7] = (int16_t)((int)(a0 - b0) >> XVID_ROW_SHIFT);
    } else {
      const int a0 = k >> XVID_ROW_SHIFT;
      if (!a0) return false;
      for (int i = 0; i < 8; i++) in[i] = (int16_t)a0;
    }
  } else if (!(left | right)) {
    const int a0 = (int)(rnd + c4 * (in[0] + in[4])) >> XVID_ROW_SHIFT;
    const int a1 = (int)(rnd + c4 * (in[0] - in[4])) >> XVID_ROW_SHIFT;
    in[0] = in[3] = in[4] = in[7] = (int16_t)a0;
    in[1] = in[2] = in[5] = in[6] = (int16_t)a1;
  } else {
    const unsigned k = c4 * in[0] + rnd;
    const unsigned a0 = k + c2 * in[2] + c4 * in[4] + c6 * in[6];
    const unsigned a1 = k + c6 * in[2] - c4 * in[4] - c2 * in[6];
    const unsigned a2 = k - c6 * in[2] - c4 * in[4] + c2 * in[6];
    const unsigned a3 = k - c2 * in[2] + c4 * in[4] - c6 * in[6];
    const unsigned b0 = c1 * in[1] + c3 * in[3] + c5 * in[5] + c7 * in[7];
    const unsigned b1 = c3 * in[1] - c7 * in[3] - c1 * in[5] - c5 * in[7];
    const unsigned b2 = c5 * in[1] - c1 * in[3] + c7 * in[5] + c3 * in[7];
    const unsigned b3 = c7 * in[1] - c5 * in[3] + c3 * in[5] - c1 * in[7];
    in[0] = (int16_t)((int)(a0 + b0) >> XVID_ROW_SHIFT);
    in[1] = (int16_t)((int)(a1 + b1) >> XVID_ROW_SHIFT);
    in[2] = (int16_t)((int)(a2 + b2) >> XVID_ROW_SHIFT);
    in[3] = (int16_t)((int)(a3 + b3) >> XVID_ROW_SHIFT);
    in[4] = (int16_t)((int)(a3 - b3) >> XVID_ROW_SHIFT);
    in[5] = (int16_t)((int)(a2 - b2) >> XVID_ROW_SHIFT);
    in[6] = (int16_t)((int)(a1 - b1) >> XVID_ROW_SHIFT);
    in[7] = (int16_t)((int)(a0 - b0) >> XVID_ROW_SHIFT);
  }
  return true;
}

inline int xvid_mult(unsigned c, int x) { return (int)((unsigned)((int)(c * (unsigned)x) >> 16)); }

// One column (stride 8) after rows: `rows` 8 when rows 4-7 may be non-zero,
// 4 when only rows 0-3, 3 when only rows 0-2.
void xvid_idct_col(int16_t* in, int rows) {
  int mm0, mm1, mm2, mm3, mm4, mm5, mm6, mm7, spill;
  if (rows == 8) {
    mm4 = in[7 * 8];
    mm5 = in[5 * 8];
    mm6 = in[3 * 8];
    mm7 = in[1 * 8];
    mm0 = xvid_mult(XVID_TAN1, mm4) + mm7;
    mm1 = xvid_mult(XVID_TAN1, mm7) - mm4;
    mm2 = xvid_mult(XVID_TAN3, mm5) + mm6;
    mm3 = xvid_mult(XVID_TAN3, mm6) - mm5;
    mm7 = mm0 + mm2;
    mm4 = mm1 - mm3;
    mm0 = mm0 - mm2;
    mm1 = mm1 + mm3;
    mm6 = mm0 + mm1;
    mm5 = mm0 - mm1;
    mm5 = 2 * xvid_mult(XVID_SQRT2, mm5);
    mm6 = 2 * xvid_mult(XVID_SQRT2, mm6);
    mm1 = in[2 * 8];
    mm2 = in[6 * 8];
    mm3 = xvid_mult(XVID_TAN2, mm2) + mm1;
    mm2 = xvid_mult(XVID_TAN2, mm1) - mm2;
    mm0 = in[0] + in[4 * 8];
    mm1 = in[0] - in[4 * 8];
  } else if (rows == 4) {
    mm0 = in[1 * 8];
    mm2 = in[3 * 8];
    mm1 = xvid_mult(XVID_TAN1, mm0);
    mm3 = xvid_mult(XVID_TAN3, mm2);
    mm7 = mm0 + mm2;
    mm4 = mm1 - mm3;
    mm0 = mm0 - mm2;
    mm1 = mm1 + mm3;
    mm6 = mm0 + mm1;
    mm5 = mm0 - mm1;
    mm6 = 2 * xvid_mult(XVID_SQRT2, mm6);
    mm5 = 2 * xvid_mult(XVID_SQRT2, mm5);
    mm0 = mm1 = in[0];
    mm3 = in[2 * 8];
    mm2 = xvid_mult(XVID_TAN2, mm3);
  } else {
    mm7 = in[1 * 8];
    mm4 = xvid_mult(XVID_TAN1, mm7);
    mm6 = mm7 + mm4;
    mm5 = mm7 - mm4;
    mm6 = 2 * xvid_mult(XVID_SQRT2, mm6);
    mm5 = 2 * xvid_mult(XVID_SQRT2, mm5);
    mm0 = mm1 = in[0];
    mm3 = in[2 * 8];
    mm2 = xvid_mult(XVID_TAN2, mm3);
  }
  // even part and the butterflies
  spill = mm0 + mm3;
  mm3 = mm0 - mm3;
  mm0 = spill;
  spill = mm0 + mm7;
  mm7 = mm0 - mm7;
  mm0 = spill;
  in[8 * 0] = (int16_t)(mm0 >> XVID_COL_SHIFT);
  in[8 * 7] = (int16_t)(mm7 >> XVID_COL_SHIFT);
  mm0 = mm3 + mm4;
  mm4 = mm3 - mm4;
  mm3 = mm0;
  in[8 * 3] = (int16_t)(mm3 >> XVID_COL_SHIFT);
  in[8 * 4] = (int16_t)(mm4 >> XVID_COL_SHIFT);
  mm0 = mm1 + mm2;
  mm2 = mm1 - mm2;
  mm1 = mm0;
  mm0 = mm1 + mm6;
  mm6 = mm1 - mm6;
  mm1 = mm0;
  in[8 * 1] = (int16_t)(mm1 >> XVID_COL_SHIFT);
  in[8 * 6] = (int16_t)(mm6 >> XVID_COL_SHIFT);
  mm0 = mm2 + mm5;
  mm5 = mm2 - mm5;
  mm2 = mm0;
  in[8 * 2] = (int16_t)(mm2 >> XVID_COL_SHIFT);
  in[8 * 5] = (int16_t)(mm5 >> XVID_COL_SHIFT);
}

// The residual of a block (natural order), res[y * 8 + x].
void xvid_idct(const int16_t* coef, int* res) {
  int16_t b[64];
  memcpy(b, coef, sizeof b);
  static const int* const kTab[8] = {kXvidTab04, kXvidTab17, kXvidTab26, kXvidTab35,
                                     kXvidTab04, kXvidTab35, kXvidTab26, kXvidTab17};
  static const int kRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
  int rows = 0x07;
  for (int i = 0; i < 8; i++)
    if (xvid_idct_row(b + 8 * i, kTab[i], kRnd[i]) && i >= 3) rows |= 1 << i;
  int kind = (rows & 0xF0) ? 8 : (rows & 0x08) ? 4 : 3;
  for (int c = 0; c < 8; c++) xvid_idct_col(b + c, kind);
  for (int k = 0; k < 64; k++) res[k] = b[k];
}

void block_idct(const int16_t* coef, int* res, bool xvid) {
  if (xvid)
    xvid_idct(coef, res);
  else
    idct(coef, res);
}

// ---------------------------------------------------------------------------
// Planes

struct Plane {
  int w = 0, h = 0;  // coded (MB-aligned) size
  std::vector<uint8_t> px;
  void resize(int w_, int h_) {
    w = w_;
    h = h_;
    px.assign((size_t)w * h, 0);
  }
  uint8_t* row(int y) { return px.data() + (size_t)y * w; }
  const uint8_t* row(int y) const { return px.data() + (size_t)y * w; }
};

struct Frame {
  Plane p[3];
  void resize(int mbw, int mbh) {
    p[0].resize(mbw * 16, mbh * 16);
    p[1].resize(mbw * 8, mbh * 8);
    p[2].resize(mbw * 8, mbh * 8);
  }
};

// ---------------------------------------------------------------------------
// Motion compensation, as FFmpeg predicts (hpeldsp, qpeldsp,
// mpegvideo_motion and mpeg4videodsp in C): half-pel, quarter-pel, field
// rows and GMC. Reference samples are read through `window`: in place
// inside the plane, clamped to the MB-aligned plane past its edge.

// The w x h window of `p` from column x0 and (field) row y0, frame row
// ystep * (y0 + r) + yoff: in the plane itself where it lies inside (*stride
// its row step), else copied into `tmp` (row step ts) with each coordinate
// clamped into the plane, as FFmpeg's emulated edge repeats the edge of the
// MB-aligned picture.
const uint8_t* window(const Plane& p, int x0, int y0, int w, int h, int ystep, int yoff,
                      uint8_t* tmp, int ts, int* stride) {
  const int top = ystep * y0 + yoff, bottom = ystep * (y0 + h - 1) + yoff;
  if (x0 >= 0 && x0 + w <= p.w && top >= 0 && bottom < p.h) {
    *stride = ystep * p.w;
    return p.row(top) + x0;
  }
  for (int r = 0; r < h; r++) {
    const uint8_t* row = p.row(std::min(std::max(ystep * (y0 + r) + yoff, 0), p.h - 1));
    for (int c = 0; c < w; c++) tmp[r * ts + c] = row[std::min(std::max(x0 + c, 0), p.w - 1)];
  }
  *stride = ts;
  return tmp;
}

// FFmpeg's put(_no_rnd)_pixels of a window of (bw + 1) x (bh + 1): half-pel
// offset dxy (bit 0 x, bit 1 y); rnd 0 rounds half up, 1 rounds down.
void hpel(const uint8_t* s, int ss, int dxy, int bw, int bh, int rnd, uint8_t* d, int ds) {
  switch (dxy) {
    case 0:
      for (int y = 0; y < bh; y++) memcpy(d + y * ds, s + y * ss, bw);
      break;
    case 1:
      for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
          const uint8_t* p = s + y * ss + x;
          d[y * ds + x] = (uint8_t)((p[0] + p[1] + 1 - rnd) >> 1);
        }
      break;
    case 2:
      for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
          const uint8_t* p = s + y * ss + x;
          d[y * ds + x] = (uint8_t)((p[0] + p[ss] + 1 - rnd) >> 1);
        }
      break;
    default:
      for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
          const uint8_t* p = s + y * ss + x;
          d[y * ds + x] = (uint8_t)((p[0] + p[1] + p[ss] + p[ss + 1] + 2 - rnd) >> 2);
        }
  }
}

// Predicts a bw x bh block from (x0, y0) of p (field rows: ystep 2, yoff
// the field) at half-pel offset dxy.
void hpel_block(const Plane& p, int x0, int y0, int ystep, int yoff, int dxy, int bw, int bh,
                int rnd, uint8_t* d, int ds) {
  uint8_t tmp[17 * 17];
  int ss;
  const uint8_t* s = window(p, x0, y0, bw + 1, bh + 1, ystep, yoff, tmp, bw + 1, &ss);
  hpel(s, ss, dxy, bw, bh, rnd, d, ds);
}

// The MPEG-4 quarter-pel filter (taps 20, -6, 3, -1, mirrored at the block's
// edges) over n outputs per row of `rows` rows, and down n columns.
void qpel_h(const uint8_t* s, int ss, uint8_t* d, int ds, int n, int rows, int rnd) {
  auto at = [n](int j) { return j < 0 ? -1 - j : j > n ? 2 * n + 1 - j : j; };
  for (int r = 0; r < rows; r++) {
    const uint8_t* p = s + r * ss;
    for (int i = 0; i < n; i++) {
      int v = (p[at(i)] + p[at(i + 1)]) * 20 - (p[at(i - 1)] + p[at(i + 2)]) * 6 +
              (p[at(i - 2)] + p[at(i + 3)]) * 3 - (p[at(i - 3)] + p[at(i + 4)]);
      d[r * ds + i] = clip_pixel((v + 16 - rnd) >> 5);
    }
  }
}

void qpel_v(const uint8_t* s, int ss, uint8_t* d, int ds, int n, int rnd) {
  auto at = [n](int j) { return j < 0 ? -1 - j : j > n ? 2 * n + 1 - j : j; };
  for (int c = 0; c < n; c++)
    for (int i = 0; i < n; i++) {
      auto p = [&](int j) { return (int)s[at(j) * ss + c]; };
      int v = (p(i) + p(i + 1)) * 20 - (p(i - 1) + p(i + 2)) * 6 + (p(i - 2) + p(i + 3)) * 3 -
              (p(i - 3) + p(i + 4));
      d[i * ds + c] = clip_pixel((v + 16 - rnd) >> 5);
    }
}

void avg2(const uint8_t* a, int as, const uint8_t* b, int bs, uint8_t* d, int ds, int n, int rows,
          int rnd) {
  for (int r = 0; r < rows; r++)
    for (int c = 0; c < n; c++) d[r * ds + c] = (uint8_t)((a[r * as + c] + b[r * bs + c] + 1 - rnd) >> 1);
}

// FFmpeg's (put|put_no_rnd)_qpel{8,16}_mcXY_c over a window of (n + 1) x
// (n + 1) samples: quarter-pel offset dxy (bits 0-1 x, 2-3 y).
void qpel(const uint8_t* s, int ss, int n, int dxy, int rnd, uint8_t* d, int ds) {
  const int x = dxy & 3, y = dxy >> 2;
  uint8_t half_h[17 * 17], half[16 * 16];
  if (y == 0) {
    if (x == 0) {
      for (int r = 0; r < n; r++) memcpy(d + r * ds, s + r * ss, n);
    } else if (x == 2) {
      qpel_h(s, ss, d, ds, n, n, rnd);
    } else {
      qpel_h(s, ss, half, 16, n, n, rnd);
      avg2(s + (x == 3), ss, half, 16, d, ds, n, n, rnd);
    }
    return;
  }
  if (x == 0) {
    if (y == 2) {
      qpel_v(s, ss, d, ds, n, rnd);
    } else {
      qpel_v(s, ss, half, 16, n, rnd);
      avg2(s + (y == 3) * ss, ss, half, 16, d, ds, n, n, rnd);
    }
    return;
  }
  qpel_h(s, ss, half_h, 17, n, n + 1, rnd);
  if (x != 2) avg2(half_h, 17, s + (x == 3), ss, half_h, 17, n, n + 1, rnd);
  if (y == 2) {
    qpel_v(half_h, 17, d, ds, n, rnd);
  } else {
    qpel_v(half_h, 17, half, 16, n, rnd);
    avg2(half_h + (y == 3) * 17, 17, half, 16, d, ds, n, n, rnd);
  }
}

// Predicts an n x n luma block from (x0, y0) (field rows as in hpel_block)
// at quarter-pel offset dxy.
void qpel_block(const Plane& p, int x0, int y0, int ystep, int yoff, int dxy, int n, int rnd,
                uint8_t* d, int ds) {
  uint8_t tmp[17 * 17];
  int ss;
  const uint8_t* s = window(p, x0, y0, n + 1, n + 1, ystep, yoff, tmp, 17, &ss);
  qpel(s, ss, n, dxy, rnd, d, ds);
}

// FFmpeg's ff_gmc_c: 8 columns of h rows warped by the affine map whose
// 16.16 fixed-point source position starts at (ox, oy) and steps by (dxx,
// dyx) per column and (dxy, dyy) per row; `width` and `height` are the
// plane's (its edge past them repeats).
void gmc8(const Plane& p, uint8_t* d, int ds, int h, int ox, int oy, int dxx, int dxy, int dyx,
          int dyy, int shift, int r) {
  const int s = 1 << shift, width = p.w - 1, height = p.h - 1;
  auto px = [&p](int x, int y) { return (int)p.row(y)[x]; };
  for (int y = 0; y < h; y++) {
    int vx = ox, vy = oy;
    for (int x = 0; x < 8; x++) {
      int src_x = vx >> 16, src_y = vy >> 16;
      const int frac_x = src_x & (s - 1), frac_y = src_y & (s - 1);
      src_x >>= shift;
      src_y >>= shift;
      int v;
      if ((unsigned)src_x < (unsigned)width) {
        if ((unsigned)src_y < (unsigned)height) {
          v = ((px(src_x, src_y) * (s - frac_x) + px(src_x + 1, src_y) * frac_x) * (s - frac_y) +
               (px(src_x, src_y + 1) * (s - frac_x) + px(src_x + 1, src_y + 1) * frac_x) * frac_y +
               r) >> (shift * 2);
        } else {
          const int yy = std::min(std::max(src_y, 0), height);
          v = ((px(src_x, yy) * (s - frac_x) + px(src_x + 1, yy) * frac_x) * s + r) >> (shift * 2);
        }
      } else {
        const int xx = std::min(std::max(src_x, 0), width);
        if ((unsigned)src_y < (unsigned)height) {
          v = ((px(xx, src_y) * (s - frac_y) + px(xx, src_y + 1) * frac_y) * s + r) >> (shift * 2);
        } else {
          v = px(xx, std::min(std::max(src_y, 0), height));
        }
      }
      d[y * ds + x] = (uint8_t)v;
      vx += dxx;
      vy += dyx;
    }
    ox += dxy;
    oy += dyy;
  }
}

// FFmpeg's gmc1_c: 8 columns of h rows, bilinear at sixteenth-pel (x16,
// y16) over a window with one more row and column.
void gmc1(const uint8_t* s, int ss, uint8_t* d, int ds, int h, int x16, int y16, int rounder) {
  const int A = (16 - x16) * (16 - y16), B = x16 * (16 - y16), C = (16 - x16) * y16, D = x16 * y16;
  for (int y = 0; y < h; y++)
    for (int x = 0; x < 8; x++) {
      const uint8_t* p = s + y * ss + x;
      d[y * ds + x] = (uint8_t)((A * p[0] + B * p[1] + C * p[ss] + D * p[ss + 1] + rounder) >> 8);
    }
}

// The chroma vector of 4MV from the sum of the four luma vectors (half-pel):
// Table 7-9's sixteenth-pel rounding.
int round_chroma_4mv(int x) {
  static const uint8_t tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
  return tab[x & 0xf] + ((x >> 3) & ~1);
}

// ---------------------------------------------------------------------------
// Stream headers

struct Vol {
  bool valid = false;
  int width = 0, height = 0;
  int time_resolution = 0, time_bits = 1;
  int quant_precision = 5;
  bool resync_disable = true;
  int ver_id = 1;
  int vo_type = 0;
  bool control_parameters = false;
  bool interlaced = false;
  int sprite = 0;  // sprite_enable: 2 GMC
  int warping_points = 0, warping_accuracy = 0;
  bool mpeg_quant = false;
  uint8_t intra_matrix[64], inter_matrix[64];  // natural order
  bool quarter_sample = false;
};

struct MbState {  // per-MB motion and prediction state, with a border
  int mbw = 0, mbh = 0;
  int ys = 0, cs = 0;             // strides of the luma 8x8 grid and the MB grid
  std::vector<int16_t> dc[3];     // DC predictors (dequantised), 1024 at borders
  std::vector<int16_t> ac[3];     // 16 per block: [1..7] first column, [9..15] first row
  std::vector<int16_t> mv;        // 2 per luma block
  std::vector<uint8_t> qscale;    // per MB

  void resize(int w, int h) {
    mbw = w;
    mbh = h;
    ys = 2 * mbw + 2;
    cs = mbw + 2;
    size_t ny = (size_t)ys * (2 * mbh + 1), nc = (size_t)cs * (mbh + 1);
    dc[0].assign(ny, 1024);
    dc[1].assign(nc, 1024);
    dc[2].assign(nc, 1024);
    ac[0].assign(ny * 16, 0);
    ac[1].assign(nc * 16, 0);
    ac[2].assign(nc * 16, 0);
    mv.assign(ny * 2, 0);
    qscale.assign(nc, 0);
  }
  int yidx(int bx, int by) const { return (by + 1) * ys + bx + 1; }
  int cidx(int mx, int my) const { return (my + 1) * cs + mx + 1; }
};


// The kind of an MB's prediction (an intra MB: none).
enum MbKind : uint8_t { kIntraMb, k16x16, k8x8, kFieldMb, kGmcMb };

// The motion of one direction of an inter MB (FFmpeg's mv_type, mv and
// field_select).
struct Motion {
  int type = k16x16;  // k16x16, k8x8, kFieldMb or kGmcMb
  int mv[4][2] = {};  // 16x16: [0]; 8x8: per block; field: [0] top, [1] bottom
  int sel[2] = {0, 1};
};

// How many VOPs, MBs and refusals of each kind the decoder met (the tools a
// stream really uses: a fixture's tests read them).
enum Stat {
  kStatI, kStatP, kStatB, kStatS, kStatNotCoded, kStatBDropped, kStatPackedVops, kStatMcsel,
  kStatFieldDct, kStatFieldMv, kStatDirect, kStatDirectField, kStat4Mv, kStatQpelMv,
  kStatCount
};

// Where an MB's prediction goes: its luma 16x16 and chroma 8x8 blocks and
// their row steps (the MB's place in the picture, or a buffer).
struct Pred {
  uint8_t *y, *u, *v;
  int ys, cs;
};

// ---------------------------------------------------------------------------
// The state and reconstruction that the decoder and the encoder share

class Codec {
 public:
  int width = 0, height = 0;
  // The stream's VOL: the decoder reads it; the encoder's is Simple
  // Profile's, every Advanced Simple tool off, so that its MBs take the
  // half-pel, H.263-quantised paths below.
  Vol vol;
  int64_t stats[kStatCount] = {};  // by Stat: what the decoder met

 protected:
  Frame cur_;  // the picture being coded
  MbState st_;
  int mbw_ = 0, mbh_ = 0;
  int pict_ = 0, qscale_ = 1, rounding_ = 0, fcode_ = 1;
  int mb_x_ = 0, mb_y_ = 0, resync_x_ = 0, resync_y_ = 0;
  bool first_line_ = true;
  bool ac_pred_ = false;
  int y_dc_ = 8, c_dc_ = 8;
  int16_t block_[6][64];
  int last_index_[6];
  bool xvid_idct_ = false;  // FFmpeg's Xvid IDCT in place of its simple IDCT
  bool interlaced_dct_ = false;  // the MB's luma blocks are fields
  uint16_t intra_matrix_[64], inter_matrix_[64];  // MPEG quantisation's
  // GMC: FFmpeg's sprite_offset, sprite_delta and sprite_shift, and how
  // many points the warp really needs (1: a translation).
  int sprite_offset_[2][2] = {}, sprite_delta_[2][2] = {}, sprite_shift_[2] = {};
  int real_warping_points_ = 0;

  void init_size(int w, int h) {
    width = w;
    height = h;
    mbw_ = (w + 15) / 16;
    mbh_ = (h + 15) / 16;
    cur_.resize(mbw_, mbh_);
    st_.resize(mbw_, mbh_);
  }

  void set_qscale(int q) {
    qscale_ = std::min(std::max(q, 1), 31);
    y_dc_ = y_dc_scale(qscale_);
    c_dc_ = c_dc_scale(qscale_);
  }

  // A video packet (or the VOP) starts at the current MB.
  void start_packet() {
    resync_x_ = mb_x_;
    resync_y_ = mb_y_;
    first_line_ = true;
  }

  int16_t* mv_at(int bx, int by) { return &st_.mv[(size_t)st_.yidx(bx, by) * 2]; }

  // FFmpeg's ff_h263_pred_motion: the median of the left, top and top-right
  // vectors, with the H.263 rules at a packet's first line.
  void pred_motion(int block, int* px, int* py) {
    const int bx = 2 * mb_x_ + (block & 1), by = 2 * mb_y_ + (block >> 1);
    static const int off[4] = {2, 1, 1, -1};
    int16_t* A = mv_at(bx - 1, by);
    if (first_line_ && block < 3) {
      if (block == 0) {
        if (mb_x_ == resync_x_) {
          *px = *py = 0;
        } else if (mb_x_ + 1 == resync_x_) {
          int16_t* C = mv_at(bx + off[block], by - 1);
          if (mb_x_ == 0) {
            *px = C[0];
            *py = C[1];
          } else {
            *px = mid_pred(A[0], 0, C[0]);
            *py = mid_pred(A[1], 0, C[1]);
          }
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else if (block == 1) {
        if (mb_x_ + 1 == resync_x_) {
          int16_t* C = mv_at(bx + off[block], by - 1);
          *px = mid_pred(A[0], 0, C[0]);
          *py = mid_pred(A[1], 0, C[1]);
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else {
        int16_t* B = mv_at(bx, by - 1);
        int16_t* C = mv_at(bx + off[block], by - 1);
        if (mb_x_ == resync_x_) A[0] = A[1] = 0;
        *px = mid_pred(A[0], B[0], C[0]);
        *py = mid_pred(A[1], B[1], C[1]);
      }
    } else {
      int16_t* B = mv_at(bx, by - 1);
      int16_t* C = mv_at(bx + off[block], by - 1);
      *px = mid_pred(A[0], B[0], C[0]);
      *py = mid_pred(A[1], B[1], C[1]);
    }
  }

  void set_mvs(int mx, int my) {
    for (int b = 0; b < 4; b++) {
      int16_t* p = mv_at(2 * mb_x_ + (b & 1), 2 * mb_y_ + (b >> 1));
      p[0] = (int16_t)mx;
      p[1] = (int16_t)my;
    }
  }

  // An inter MB predicts no DC or AC of its neighbours.
  void clean_intra_entries() {
    for (int b = 0; b < 4; b++) {
      int idx = st_.yidx(2 * mb_x_ + (b & 1), 2 * mb_y_ + (b >> 1));
      st_.dc[0][idx] = 1024;
      memset(&st_.ac[0][(size_t)idx * 16], 0, 16 * sizeof(int16_t));
    }
    int c = st_.cidx(mb_x_, mb_y_);
    for (int k = 1; k < 3; k++) {
      st_.dc[k][c] = 1024;
      memset(&st_.ac[k][(size_t)c * 16], 0, 16 * sizeof(int16_t));
    }
  }

  int16_t* dc_entry(int n) {
    if (n < 4) return &st_.dc[0][st_.yidx(2 * mb_x_ + (n & 1), 2 * mb_y_ + (n >> 1))];
    return &st_.dc[n - 3][st_.cidx(mb_x_, mb_y_)];
  }

  // FFmpeg's ff_mpeg4_pred_dc: decoding adds the prediction to the
  // differential `level` and returns the DC level; encoding takes the level
  // and returns the differential. Either way the dequantised DC is kept.
  int pred_dc(int n, int level, int* dir, bool encoding) {
    int scale = n < 4 ? y_dc_ : c_dc_;
    int wrap = n < 4 ? st_.ys : st_.cs;
    int16_t* dc = dc_entry(n);
    int a = dc[-1], b = dc[-1 - wrap], c = dc[-wrap];
    if (first_line_ && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x_ == resync_x_) b = a = 1024;
    }
    if (mb_x_ == resync_x_ && mb_y_ == resync_y_ + 1) {
      if (n == 0 || n == 4 || n == 5) b = 1024;
    }
    int pred;
    if (std::abs(a - b) < std::abs(b - c)) {
      pred = c;
      *dir = 1;
    } else {
      pred = a;
      *dir = 0;
    }
    pred = (pred + (scale >> 1)) / scale;
    int ret;
    if (encoding) {
      ret = level - pred;
    } else {
      level += pred;
      ret = level;
    }
    level *= scale;
    if (level & ~2047) level = level < 0 ? 0 : 2047;
    dc[0] = (int16_t)level;
    return ret;
  }

  static int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

  int16_t* ac_entry(int n) {
    if (n < 4)
      return &st_.ac[0][(size_t)st_.yidx(2 * mb_x_ + (n & 1), 2 * mb_y_ + (n >> 1)) * 16];
    return &st_.ac[n - 3][(size_t)st_.cidx(mb_x_, mb_y_) * 16];
  }

  // What FFmpeg's ff_mpeg4_pred_ac adds to block n with ac_pred on, at
  // natural positions pos[1..7]: the left neighbour's first column (dir 0)
  // or the top's first row (dir 1), rescaled to this MB's qscale.
  void ac_prediction(int n, int dir, int* pred, int* pos) {
    const int16_t* ac = ac_entry(n);
    const int16_t* src;
    int q;
    bool same;
    if (dir == 0) {
      src = ac - 16;
      q = st_.qscale[st_.cidx(mb_x_ - 1, mb_y_)];
      same = mb_x_ == 0 || qscale_ == q || n == 1 || n == 3;
    } else {
      src = ac - 16 * (n < 4 ? st_.ys : st_.cs) + 8;
      q = st_.qscale[st_.cidx(mb_x_, mb_y_ - 1)];
      same = first_line_ || qscale_ == q || n == 2 || n == 3;
    }
    for (int i = 1; i < 8; i++) {
      pos[i] = dir == 0 ? i << 3 : i;
      pred[i] = same ? src[i] : rounded_div(src[i] * q, qscale_);
    }
  }

  // FFmpeg's ff_mpeg4_pred_ac: adds the prediction when ac_pred is on, then
  // keeps this block's first column and row for the blocks to come.
  void pred_ac(int16_t* block, int n, int dir) {
    if (ac_pred_) {
      int pred[8], pos[8];
      ac_prediction(n, dir, pred, pos);
      for (int i = 1; i < 8; i++) block[pos[i]] = (int16_t)(block[pos[i]] + pred[i]);
    }
    int16_t* ac = ac_entry(n);
    for (int i = 1; i < 8; i++) {
      ac[i] = block[i << 3];
      ac[8 + i] = block[i];
    }
  }

  // FFmpeg's ff_mpeg4_clean_buffers at a video packet: the AC predictors of
  // the earlier packets' blocks that border this one are cleared (luma 8x8
  // rows 2 mb_y - 1 from column 2 mb_x - 1, 2 mb_y, and 2 mb_y + 1 up to
  // column 2 mb_x - 1: one run in FFmpeg's layout).
  void clean_buffers() {
    auto clear_y = [&](int bx, int by) {
      if (by >= 0) memset(&st_.ac[0][(size_t)st_.yidx(bx, by) * 16], 0, 16 * sizeof(int16_t));
    };
    for (int bx = std::max(2 * mb_x_ - 1, 0); bx < 2 * mbw_; bx++) clear_y(bx, 2 * mb_y_ - 1);
    for (int bx = 0; bx < 2 * mbw_; bx++) clear_y(bx, 2 * mb_y_);
    for (int bx = 0; bx <= 2 * mb_x_ - 1; bx++) clear_y(bx, 2 * mb_y_ + 1);
    for (int c = 1; c < 3; c++) {
      auto clear_c = [&](int mx, int my) {
        if (my >= 0) memset(&st_.ac[c][(size_t)st_.cidx(mx, my) * 16], 0, 16 * sizeof(int16_t));
      };
      for (int mx = std::max(mb_x_ - 1, 0); mx < mbw_; mx++) clear_c(mx, mb_y_ - 1);
      for (int mx = 0; mx <= mb_x_ - 1; mx++) clear_c(mx, mb_y_);
    }
  }

  uint8_t* dest(int plane, int n) {
    if (plane == 0) return cur_.p[0].row(mb_y_ * 16 + (n >> 1) * 8) + mb_x_ * 16 + (n & 1) * 8;
    return cur_.p[plane].row(mb_y_ * 8) + mb_x_ * 8;
  }

  // ---- prediction

  // One direction's prediction of the MB (FFmpeg's mpv_motion_internal).
  void predict(const Frame& ref, const Motion& m, int rnd, const Pred& p) {
    if (m.type == kGmcMb) {
      predict_gmc(ref, rnd, p);
    } else if (m.type == k8x8) {
      predict_8x8(ref, m, rnd, p);
    } else if (m.type == kFieldMb) {
      for (int i = 0; i < 2; i++) predict_field(ref, m.mv[i][0], m.mv[i][1], i, m.sel[i], rnd, p);
    } else if (vol.quarter_sample) {
      predict_qpel16(ref, m.mv[0][0], m.mv[0][1], rnd, p);
    } else {
      const int mx = m.mv[0][0], my = m.mv[0][1];
      const int dxy = ((my & 1) << 1) | (mx & 1);
      const int sx = mb_x_ * 16 + (mx >> 1), sy = mb_y_ * 16 + (my >> 1);
      hpel_block(ref.p[0], sx, sy, 1, 0, dxy, 16, 16, rnd, p.y, p.ys);
      const int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      hpel_block(ref.p[1], sx >> 1, sy >> 1, 1, 0, uvdxy, 8, 8, rnd, p.u, p.cs);
      hpel_block(ref.p[2], sx >> 1, sy >> 1, 1, 0, uvdxy, 8, 8, rnd, p.v, p.cs);
    }
  }

  // FFmpeg's qpel_motion of a frame MB.
  void predict_qpel16(const Frame& ref, int mx, int my, int rnd, const Pred& p) {
    if (mx & 3 || my & 3) stats[kStatQpelMv]++;
    const int dxy = ((my & 3) << 2) | (mx & 3);
    qpel_block(ref.p[0], mb_x_ * 16 + (mx >> 2), mb_y_ * 16 + (my >> 2), 1, 0, dxy, 16, rnd, p.y, p.ys);
    int cx = mx / 2, cy = my / 2;
    cx = (cx >> 1) | (cx & 1);
    cy = (cy >> 1) | (cy & 1);
    const int uvdxy = (cx & 1) | ((cy & 1) << 1);
    const int ux = mb_x_ * 8 + (cx >> 1), uy = mb_y_ * 8 + (cy >> 1);
    hpel_block(ref.p[1], ux, uy, 1, 0, uvdxy, 8, 8, rnd, p.u, p.cs);
    hpel_block(ref.p[2], ux, uy, 1, 0, uvdxy, 8, 8, rnd, p.v, p.cs);
  }

  // One field of a field MB: rows i, i + 2, ... of the MB from field `sel`
  // of the reference (FFmpeg's mpeg_motion_field, or qpel_motion with
  // field_based).
  void predict_field(const Frame& ref, int mx, int my, int i, int sel, int rnd, const Pred& p) {
    if (vol.quarter_sample) {
      if (mx & 3 || my & 3) stats[kStatQpelMv]++;
      const int dxy = ((my & 3) << 2) | (mx & 3);
      const int sx = mb_x_ * 16 + (mx >> 2), sy = mb_y_ * 8 + (my >> 2);
      for (int h = 0; h < 2; h++)
        qpel_block(ref.p[0], sx + 8 * h, sy, 2, sel, dxy, 8, rnd, p.y + p.ys * i + 8 * h, 2 * p.ys);
      int cx = mx / 2, cy = my >> 1;
      cx = (cx >> 1) | (cx & 1);
      cy = (cy >> 1) | (cy & 1);
      const int uvdxy = (cx & 1) | ((cy & 1) << 1);
      const int ux = mb_x_ * 8 + (cx >> 1), uy = mb_y_ * 4 + (cy >> 1);
      hpel_block(ref.p[1], ux, uy, 2, sel, uvdxy, 8, 4, rnd, p.u + p.cs * i, 2 * p.cs);
      hpel_block(ref.p[2], ux, uy, 2, sel, uvdxy, 8, 4, rnd, p.v + p.cs * i, 2 * p.cs);
      return;
    }
    const int dxy = ((my & 1) << 1) | (mx & 1);
    const int sx = mb_x_ * 16 + (mx >> 1), sy = mb_y_ * 8 + (my >> 1);
    hpel_block(ref.p[0], sx, sy, 2, sel, dxy, 16, 8, rnd, p.y + p.ys * i, 2 * p.ys);
    const int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
    hpel_block(ref.p[1], sx >> 1, sy >> 1, 2, sel, uvdxy, 8, 4, rnd, p.u + p.cs * i, 2 * p.cs);
    hpel_block(ref.p[2], sx >> 1, sy >> 1, 2, sel, uvdxy, 8, 4, rnd, p.v + p.cs * i, 2 * p.cs);
  }

  // FFmpeg's apply_8x8: four luma blocks and one chroma vector.
  void predict_8x8(const Frame& ref, const Motion& m, int rnd, const Pred& p) {
    int sumx = 0, sumy = 0;
    for (int i = 0; i < 4; i++) {
      const int mx = m.mv[i][0], my = m.mv[i][1];
      uint8_t* d = p.y + (i >> 1) * 8 * p.ys + (i & 1) * 8;
      if (vol.quarter_sample) {
        if (mx & 3 || my & 3) stats[kStatQpelMv]++;
        int dxy = ((my & 3) << 2) | (mx & 3);
        int sx = mb_x_ * 16 + (mx >> 2) + (i & 1) * 8, sy = mb_y_ * 16 + (my >> 2) + (i >> 1) * 8;
        sx = std::min(std::max(sx, -16), width);
        if (sx == width) dxy &= ~3;
        sy = std::min(std::max(sy, -16), height);
        if (sy == height) dxy &= ~12;
        qpel_block(ref.p[0], sx, sy, 1, 0, dxy, 8, rnd, d, p.ys);
        sumx += mx / 2;
        sumy += my / 2;
      } else {
        int sx = mb_x_ * 16 + (i & 1) * 8 + (mx >> 1), sy = mb_y_ * 16 + (i >> 1) * 8 + (my >> 1);
        int dxy = 0;
        sx = std::min(std::max(sx, -16), width);
        if (sx != width) dxy |= mx & 1;
        sy = std::min(std::max(sy, -16), height);
        if (sy != height) dxy |= (my & 1) << 1;
        hpel_block(ref.p[0], sx, sy, 1, 0, dxy, 8, 8, rnd, d, p.ys);
        sumx += mx;
        sumy += my;
      }
    }
    const int mx = round_chroma_4mv(sumx), my = round_chroma_4mv(sumy);
    int dxy = ((my & 1) << 1) | (mx & 1);
    int sx = mb_x_ * 8 + (mx >> 1), sy = mb_y_ * 8 + (my >> 1);
    sx = std::min(std::max(sx, -8), width >> 1);
    if (sx == (width >> 1)) dxy &= ~1;
    sy = std::min(std::max(sy, -8), height >> 1);
    if (sy == (height >> 1)) dxy &= ~2;
    hpel_block(ref.p[1], sx, sy, 1, 0, dxy, 8, 8, rnd, p.u, p.cs);
    hpel_block(ref.p[2], sx, sy, 1, 0, dxy, 8, 8, rnd, p.v, p.cs);
  }

  // FFmpeg's gmc1_motion (a translation) and gmc_motion (the warp).
  void predict_gmc(const Frame& ref, int rnd, const Pred& p) {
    const int acc = vol.warping_accuracy;
    if (real_warping_points_ == 1) {
      for (int plane = 0; plane < 3; plane++) {
        const bool luma = plane == 0;
        const int size = luma ? 16 : 8;
        int mx = sprite_offset_[luma ? 0 : 1][0], my = sprite_offset_[luma ? 0 : 1][1];
        int sx = (luma ? mb_x_ * 16 : mb_x_ * 8) + (mx >> (acc + 1));
        int sy = (luma ? mb_y_ * 16 : mb_y_ * 8) + (my >> (acc + 1));
        mx *= 1 << (3 - acc);
        my *= 1 << (3 - acc);
        const int w = luma ? width : width >> 1, h = luma ? height : height >> 1;
        sx = std::min(std::max(sx, -size), w);
        if (sx == w) mx = 0;
        sy = std::min(std::max(sy, -size), h);
        if (sy == h) my = 0;
        uint8_t tmp[17 * 17];
        int ss;
        const uint8_t* s = window(ref.p[plane], sx, sy, size + 1, size + 1, 1, 0, tmp, 17, &ss);
        uint8_t* d = plane == 0 ? p.y : plane == 1 ? p.u : p.v;
        const int ds = luma ? p.ys : p.cs;
        if (!luma || (mx | my) & 7) {
          for (int h8 = 0; h8 < size; h8 += 8)
            gmc1(s + h8, ss, d + h8, ds, size, mx & 15, my & 15, 128 - rnd);
        } else {
          hpel(s, ss, ((mx >> 3) & 1) | ((my >> 2) & 2), 16, 16, rnd, d, ds);
        }
      }
      return;
    }
    const int dxx = sprite_delta_[0][0], dxy = sprite_delta_[0][1];
    const int dyx = sprite_delta_[1][0], dyy = sprite_delta_[1][1];
    const int shift = acc + 1, r = (1 << (2 * acc + 1)) - rnd;
    int ox = sprite_offset_[0][0] + dxx * mb_x_ * 16 + dxy * mb_y_ * 16;
    int oy = sprite_offset_[0][1] + dyx * mb_x_ * 16 + dyy * mb_y_ * 16;
    gmc8(ref.p[0], p.y, p.ys, 16, ox, oy, dxx, dxy, dyx, dyy, shift, r);
    gmc8(ref.p[0], p.y + 8, p.ys, 16, ox + dxx * 8, oy + dyx * 8, dxx, dxy, dyx, dyy, shift, r);
    ox = sprite_offset_[1][0] + dxx * mb_x_ * 8 + dxy * mb_y_ * 8;
    oy = sprite_offset_[1][1] + dyx * mb_x_ * 8 + dyy * mb_y_ * 8;
    gmc8(ref.p[1], p.u, p.cs, 8, ox, oy, dxx, dxy, dyx, dyy, shift, r);
    gmc8(ref.p[2], p.v, p.cs, 8, ox, oy, dxx, dxy, dyx, dyy, shift, r);
  }

  // The luma block n of the MB in cur_ (field DCT: its rows interleave).
  uint8_t* luma_block(int n, int* stride) {
    const int w = cur_.p[0].w;
    if (interlaced_dct_) {
      *stride = 2 * w;
      return cur_.p[0].row(mb_y_ * 16 + (n >> 1)) + mb_x_ * 16 + (n & 1) * 8;
    }
    *stride = w;
    return dest(0, n);
  }

  uint8_t* block_dest(int n, int* stride) {
    if (n < 4) return luma_block(n, stride);
    *stride = cur_.p[n - 3].w;
    return dest(n - 3, n);
  }

  // FFmpeg's dct_unquantize_mpeg2_inter: the matrix, then mismatch control
  // on the last coefficient.
  void dequant_mpeg_inter(int16_t* b) {
    int sum = -1;
    for (int j = 0; j < 64; j++) {
      int level = b[j];
      if (!level) continue;
      int v = (((std::abs(level) << 1) + 1) * (qscale_ << 1) * inter_matrix_[j]) >> 5;
      level = level < 0 ? -v : v;
      b[j] = (int16_t)level;
      sum += level;
    }
    b[63] ^= (int16_t)(sum & 1);
  }

  // Intra MB: block_ holds quantised levels (the DC with its prediction).
  void reconstruct_intra() {
    const int qmul = qscale_ << 1, qadd = (qscale_ - 1) | 1;
    for (int n = 0; n < 6; n++) {
      int16_t* b = block_[n];
      b[0] = (int16_t)(b[0] * (n < 4 ? y_dc_ : c_dc_));
      for (int k = 1; k < 64; k++) {
        int level = b[k];
        if (!level) continue;
        if (vol.mpeg_quant) {  // dct_unquantize_mpeg2_intra (no mismatch control)
          int v = (std::abs(level) * (qscale_ << 1) * intra_matrix_[k]) >> 4;
          b[k] = (int16_t)(level < 0 ? -v : v);
        } else {
          b[k] = (int16_t)(level < 0 ? level * qmul - qadd : level * qmul + qadd);
        }
      }
      int stride;
      uint8_t* d = block_dest(n, &stride);
      idct_put(b, d, stride, xvid_idct_);
    }
  }


  // The MB's place in cur_, where its prediction goes.
  Pred in_picture() {
    return Pred{dest(0, 0), dest(1, 0), dest(2, 0), cur_.p[0].w, cur_.p[1].w};
  }

  // Inter MB: adds the residual of the coded blocks to the prediction in
  // cur_ (block_ holds H.263 coefficients dequantised as read, MPEG ones
  // still to dequantise).
  void add_residual() {
    for (int n = 0; n < 6; n++) {
      if (last_index_[n] < 0) continue;
      if (vol.mpeg_quant) dequant_mpeg_inter(block_[n]);
      int stride;
      uint8_t* d = block_dest(n, &stride);
      idct_add(block_[n], d, stride, xvid_idct_);
    }
  }
};

// Table B-33: the sprite trajectory's dmv_length.
const uint16_t kSpriteTrajectory[15][2] = {{0x00, 2},  {0x02, 3},  {0x03, 3},  {0x04, 3},
                                           {0x05, 3},  {0x06, 3},  {0x0e, 4},  {0x1e, 5},
                                           {0x3e, 6},  {0x7e, 7},  {0xfe, 8},  {0x1fe, 9},
                                           {0x3fe, 10}, {0x7fe, 11}, {0xffe, 12}};
// Table B-3 (mb_type of B-VOPs): direct, interpolate, backward, forward.
const uint8_t kBMbType[4][2] = {{1, 1}, {1, 2}, {1, 3}, {1, 4}};

const Vlc& sprite_vlc() {
  static const Vlc v{kSpriteTrajectory, 15, 12};
  return v;
}
const Vlc& b_mb_type_vlc() {
  static const Vlc v{kBMbType, 4, 4};
  return v;
}

// The default matrices of MPEG quantisation (natural order).
const uint8_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

inline int rounded_div64(int64_t a, int64_t b) {
  return (int)((a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b);
}

// ---------------------------------------------------------------------------
// Decoder

// What a B-VOP's direct mode and skipping read of the co-located MB of the
// anchor after it: FFmpeg's mb_type, mbskip_table, motion_val, and for a
// field MB its two vectors and field selects.
struct MbInfo {
  uint8_t kind = kIntraMb;
  uint8_t skipped = 0;
  uint8_t field_sel[2] = {0, 0};
  int16_t mv[4][2] = {};
  int16_t field_mv[2][2] = {};
};

// A decoded picture: its planes, its MBs' motion (anchors) and its tag
// (packet index * 4 + VOP ordinal in the packet).
struct Picture {
  Frame f;
  std::vector<MbInfo> mb;
  int64_t tag = -1;
};

class Decoder : public Codec {
 public:
  // The colour of the RGB conversion: the container's (an MP4 colr box), as
  // FFmpeg keeps it for a stream whose visual object sends no video signal
  // type; BT.601 and limited range without one.
  int matrix = 2, full_range = 0;
  bool headers_only = false;  // read headers and order frames; decode no MB
  std::string fourcc;         // the AVI FourCC, else empty
  int pictures = 0;           // VOPs decoded (or parsed, headers only)

  // The frame the last call output (null if none) and its tag.
  const Frame* out = nullptr;
  int64_t out_tag = -1;

  // Reads the headers before the first VOP (a decoder configuration).
  void header(const uint8_t* data, size_t n) { parse(data, n, nullptr); }

  // Decodes one packet as FFmpeg's decoder takes it (with the packed
  // bitstream's stored VOP: DivX 5's convention, which Xvid's packed mode
  // writes); `out` is the frame it outputs, if any.
  void decode(const uint8_t* data, size_t n, int64_t tag) {
    out = nullptr;
    skipped_last_ = false;
    const uint8_t* src = data;
    size_t len = n;
    int64_t src_tag = tag * 4;
    bool from_buffer = false;
    std::vector<uint8_t> stored;
    if (!buffer_.empty()) {
      bool discard = false;
      if (divx_packed_) {
        for (size_t i = 0; i + 3 < n; i++)
          if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
            discard = data[i + 3] == 0xb0;
            break;
          }
      }
      stored.swap(buffer_);
      if (!discard && (divx_packed_ || n <= 19)) {
        src = stored.data();
        len = stored.size();
        src_tag = buffer_tag_;
        from_buffer = true;
      }
    }
    size_t vop_at = 0;
    vop_tag_ = src_tag;
    int result = parse(src, len, &vop_at);
    if (result == kVopMissing) corrupt("a packet without a VOP");
    if (result != kVopDecoded) return;
    // FFmpeg's ff_mpeg4_frame_end: after a VOP of a packed stream, the
    // packet's next VOP (from the start of the packet if the stored one was
    // decoded) waits for the next packet if it is a B- or I-VOP.
    if (divx_packed_) {
      size_t from = from_buffer ? 0 : vop_at + 4;
      for (size_t i = from; i + 4 < n; i++)
        if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1 && data[i + 3] == 0xb6) {
          const size_t current = from_buffer ? 0 : i - 1;
          if (n - current > 7 && !(data[i + 4] & 0x40)) {
            buffer_.assign(data + i, data + n);
            buffer_tag_ = tag * 4 + (from_buffer ? 0 : 1);
            stats[kStatPackedVops]++;
          }
          break;
        }
    }
  }

  // The end of the stream: the last anchor, unless a low-delay stream has
  // output it already (it comes again after a final not-coded VOP, as
  // FFmpeg outputs it).
  void flush() {
    out = nullptr;
    if ((!low_delay_ || skipped_last_) && have_next_) {
      out = &next_.f;
      out_tag = next_.tag;
      have_next_ = false;
    }
    skipped_last_ = false;
  }

  // The stored VOP of a packed stream, and the anchors held: what makes two
  // decoders at the same packet agree from there on.
  bool state_equal(const Decoder& o) const {
    return buffer_ == o.buffer_ && buffer_tag_ == o.buffer_tag_ && have_next_ == o.have_next_ &&
           have_last_ == o.have_last_ && (!have_next_ || next_.tag == o.next_.tag) &&
           (!have_last_ || last_.tag == o.last_.tag) && low_delay_ == o.low_delay_ &&
           (!vol.interlaced || t_frame_ == o.t_frame_);
  }
  bool pending() const { return !buffer_.empty(); }

 private:
  enum { kVopMissing, kVopSkipped, kVopDecoded };

  int dc_threshold_ = 99;
  int xvid_build_ = -1, divx_version_ = -1;
  bool lavc_ = false, divx_packed_ = false;
  int low_delay_ = 0;
  bool skipped_last_ = false;
  std::vector<uint8_t> buffer_;  // a packed stream's stored VOP
  int64_t buffer_tag_ = -1;
  int64_t cur_tag_ = -1;

  // The anchors: next_ the latest (the reference of P- and S-VOPs and the
  // backward reference of B-VOPs), last_ the one before (the forward one).
  Picture next_, last_;
  bool have_next_ = false, have_last_ = false;
  std::vector<MbInfo> mbi_;  // the MBs of the anchor being decoded

  // FFmpeg's VOP times (ticks of vop_time_increment_resolution).
  int64_t time_base_ = 0, last_time_base_ = 0, time_ = 0, last_non_b_time_ = 0;
  uint16_t pp_time_ = 0, pb_time_ = 0, pp_field_time_ = 0, pb_field_time_ = 0;
  int t_frame_ = 0;

  // The VOP's coding state.
  int bcode_ = 1;
  bool top_field_first_ = false, alternate_scan_ = false;
  bool mcsel_ = false;
  int last_mv_[2][2][2] = {};  // B-VOPs: [direction][field][component]

  // Walks the start codes: VOS, VO, VOL, user data, GOV, then one VOP.
  // *vop_at: the VOP's start code.
  int parse(const uint8_t* data, size_t n, size_t* vop_at) {
    size_t i = 0;
    while (i + 4 <= n) {
      if (!(data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1)) {
        i++;
        continue;
      }
      const uint8_t code = data[i + 3];
      const size_t start = i + 4;
      size_t end = start;
      while (end + 3 <= n && !(data[end] == 0 && data[end + 1] == 0 && data[end + 2] == 1)) end++;
      if (end + 3 > n) end = n;
      if (code >= 0x20 && code <= 0x2f) {
        BitReader br(data + start, end - start);
        parse_vol(br);
      } else if (code == 0xb6) {
        if (!vop_at) return kVopMissing;
        if (!vol.valid) corrupt("a VOP before the video object layer header");
        *vop_at = i;
        BitReader br(data + start, n - start);
        return decode_vop(br) ? kVopDecoded : kVopSkipped;
      } else if (code == 0xb2) {
        user_data(data + start, end - start);
      } else if (code == 0xb3) {
        BitReader br(data + start, end - start);
        gov(br);
      } else if (code == 0xb5) {
        BitReader br(data + start, end - start);
        if (br.get1()) br.skip(7);  // visual_object_verid, priority
        if (br.get(4) != 1) unsupported("visual objects other than video (still texture, mesh, face)");
      }
      i = end;
    }
    return kVopMissing;
  }

  // FFmpeg's mpeg4_decode_gop_header: the GOV's time code sets the time base.
  void gov(BitReader& br) {
    if (br.left() < 23 || !br.peek(23)) return;
    int hours = (int)br.get(5), minutes = (int)br.get(6);
    br.skip(1);
    int seconds = (int)br.get(6);
    time_base_ = seconds + 60 * (minutes + 60 * hours);
  }

  // User data: the encoder stamps FFmpeg's decode_user_data reads.
  void user_data(const uint8_t* p, size_t n) {
    char buf[256];
    size_t len = 0;
    while (len < n && len < 255) {
      if (len + 3 <= n && p[len] == 0 && p[len + 1] == 0 && p[len + 2] < 2) break;
      buf[len] = (char)p[len];
      len++;
    }
    buf[len] = 0;
    int ver = 0, build = 0, ver2 = 0, ver3 = 0;
    char last = 0;
    int e = sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last);
    if (e < 2) e = sscanf(buf, "DivX%db%d%c", &ver, &build, &last);
    if (e >= 2) {
      divx_version_ = ver;
      divx_packed_ = e == 3 && last == 'p';
    }
    e = sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4) e = sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3, &build);
    if (e != 4) e = sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
    if (e == 4 || strcmp(buf, "ffmpeg") == 0) lavc_ = true;
    if (sscanf(buf, "XviD%d", &build) == 1) xvid_build_ = build;
  }

  // FFmpeg's ff_mpeg4_workaround_bugs, as far as it changes the decoding of
  // the tools this decoder reads: the IDCT, or a refusal. A DivX stamp
  // beside an Xvid one (Xvid's packed mode writes both) yields to it.
  void choose_idct() {
    int xvid = xvid_build_, divx = divx_version_;
    if (xvid < 0 && divx < 0 && !lavc_) {
      static const char* kXvidTags[] = {"XVID", "XVIX", "RMP4", "ZMP4", "SIPP"};
      for (const char* t : kXvidTags)
        if (fourcc == t) xvid = 0;
      if (xvid < 0 && fourcc == "DIVX" && vol.vo_type == 0 && !vol.control_parameters) divx = 400;
    }
    if (xvid >= 0 && divx >= 0) divx = -1;
    if (xvid >= 0 && xvid <= 32)
      unsupported("Xvid streams of build 32 or earlier, or unstamped with the FourCC XVID "
                  "(FFmpeg decodes them with bug workarounds)");
    if (divx >= 0) unsupported("DivX streams (FFmpeg decodes them with bug workarounds)");
    xvid_idct_ = xvid >= 0;
  }

  void parse_vol(BitReader& br) {
    Vol v;
    br.skip(1);  // random_accessible_vol
    v.vo_type = (int)br.get(8);
    if (v.vo_type == 0x12) unsupported("fine granularity scalability");
    if (br.get1()) {  // is_object_layer_identifier
      v.ver_id = (int)br.get(4);
      br.skip(3);
    }
    if (br.get(4) == 15) br.skip(16);  // extended pixel aspect ratio
    v.control_parameters = br.get1();
    if (v.control_parameters) {
      if (br.get(2) != 1) unsupported("chroma formats other than 4:2:0");
      low_delay_ = br.get1();
      if (br.get1()) {  // vbv_parameters
        for (int bits : {15, 15, 15}) {
          br.skip(bits);
          br.marker("in vbv_parameters");
        }
        br.skip(3 + 11);
        br.marker("in vbv_parameters");
        br.skip(15);
        br.marker("in vbv_parameters");
      }
    } else if (!pictures) {  // FFmpeg decides once: Simple and Advanced Simple are low delay
      low_delay_ = v.vo_type == 1 || v.vo_type == 17;
    }
    if (br.get(2) != 0) unsupported("non-rectangular shape");
    br.marker("before vop_time_increment_resolution");
    v.time_resolution = (int)br.get(16);
    if (!v.time_resolution) corrupt("vop_time_increment_resolution 0");
    v.time_bits = std::max(log2_floor(v.time_resolution - 1) + 1, 1);
    br.marker("after vop_time_increment_resolution");
    if (br.get1()) br.skip(v.time_bits);  // fixed_vop_rate
    br.marker("before video_object_layer_width");
    v.width = (int)br.get(13);
    br.marker("before video_object_layer_height");
    v.height = (int)br.get(13);
    br.marker("after video_object_layer_height");
    if (v.width <= 0 || v.height <= 0) corrupt("video size %dx%d", v.width, v.height);
    v.interlaced = br.get1();
    br.skip(1);  // obmc_disable
    v.sprite = (int)br.get(v.ver_id == 1 ? 1 : 2);
    if (v.sprite == 1) unsupported("static sprites");
    if (v.sprite == 3) corrupt("sprite_enable 3");
    if (v.sprite == 2) {
      v.warping_points = (int)br.get(6);
      v.warping_accuracy = (int)br.get(2);
      if (br.get1()) unsupported("sprite brightness change");
      if (v.warping_points != 3) unsupported("GMC of other than 3 warping points (Xvid's)");
    }
    if (br.get1()) unsupported("not-8-bit video");
    v.mpeg_quant = br.get1();
    memcpy(v.intra_matrix, kDefaultIntraMatrix, 64);
    memcpy(v.inter_matrix, kDefaultInterMatrix, 64);
    if (v.mpeg_quant) {
      for (uint8_t* m : {v.intra_matrix, v.inter_matrix}) {
        if (!br.get1()) continue;  // load_*_quant_mat
        int i = 0, last = 0;  // zigzag order, to an end of 0; the last value repeats
        for (; i < 64; i++) {
          int q = (int)br.get(8);
          if (!q) break;
          m[kZigzag[i]] = (uint8_t)(last = q);
        }
        for (; i < 64; i++) m[kZigzag[i]] = (uint8_t)last;
      }
    }
    v.quarter_sample = v.ver_id != 1 && br.get1();
    if (!br.get1()) unsupported("complexity estimation");
    v.resync_disable = br.get1();
    if (br.get1()) unsupported("data partitioning (and RVLC)");
    if (v.ver_id != 1) {
      if (br.get1()) unsupported("newpred");
      if (br.get1()) unsupported("reduced resolution VOPs");
    }
    if (br.get1()) unsupported("scalability");
    v.valid = true;
    bool resized = !vol.valid || v.width != vol.width || v.height != vol.height;
    vol = v;
    for (int k = 0; k < 64; k++) {
      intra_matrix_[k] = vol.intra_matrix[k];
      inter_matrix_[k] = vol.inter_matrix[k];
    }
    if (resized) {
      init_size(vol.width, vol.height);
      for (Picture* p : {&next_, &last_}) {
        p->f.resize(mbw_, mbh_);
        p->mb.assign((size_t)mbw_ * mbh_, MbInfo());
      }
      mbi_.assign((size_t)mbw_ * mbh_, MbInfo());
      have_next_ = have_last_ = false;
    }
  }

  // FFmpeg's mpeg4_decode_sprite_trajectory for three points (and the
  // simplification of a pure translation to its one-point path), with the
  // VOP's rectangle as the reference points.
  void sprite_trajectory(BitReader& br) {
    const int a = 2 << vol.warping_accuracy, rho = 3 - vol.warping_accuracy, r = 16 / a;
    const int w = width, h = height;
    const int vop_ref[4][2] = {{0, 0}, {w, 0}, {0, h}, {w, h}};
    int d[4][2] = {};
    for (int i = 0; i < vol.warping_points; i++) {
      for (int c = 0; c < 2; c++) {
        int length = br.vlc(sprite_vlc());
        int x = 0;
        if (length > 0) {
          int u = (int)br.get(length);
          x = (u >> (length - 1)) ? u : u - (1 << length) + 1;
        }
        br.marker("in sprite_trajectory");
        d[i][c] = x;
      }
    }
    int alpha = 1, beta = 0;
    while ((1 << alpha) < w) alpha++;
    while ((1 << beta) < h) beta++;
    const int w2 = 1 << alpha, h2 = 1 << beta;
    int sprite_ref[3][2];
    sprite_ref[0][0] = (a >> 1) * (2 * vop_ref[0][0] + d[0][0]);
    sprite_ref[0][1] = (a >> 1) * (2 * vop_ref[0][1] + d[0][1]);
    sprite_ref[1][0] = (a >> 1) * (2 * vop_ref[1][0] + d[0][0] + d[1][0]);
    sprite_ref[1][1] = (a >> 1) * (2 * vop_ref[1][1] + d[0][1] + d[1][1]);
    sprite_ref[2][0] = (a >> 1) * (2 * vop_ref[2][0] + d[0][0] + d[2][0]);
    sprite_ref[2][1] = (a >> 1) * (2 * vop_ref[2][1] + d[0][1] + d[2][1]);
    int64_t virtual_ref[2][2];
    virtual_ref[0][0] = 16 * (vop_ref[0][0] + w2) +
                        rounded_div64((int64_t)(w - w2) * (r * sprite_ref[0][0] - 16LL * vop_ref[0][0]) +
                                          (int64_t)w2 * (r * sprite_ref[1][0] - 16LL * vop_ref[1][0]),
                                      w);
    virtual_ref[0][1] = 16 * vop_ref[0][1] +
                        rounded_div64((int64_t)(w - w2) * (r * sprite_ref[0][1] - 16LL * vop_ref[0][1]) +
                                          (int64_t)w2 * (r * sprite_ref[1][1] - 16LL * vop_ref[1][1]),
                                      w);
    virtual_ref[1][0] = 16 * vop_ref[0][0] +
                        rounded_div64((int64_t)(h - h2) * (r * sprite_ref[0][0] - 16LL * vop_ref[0][0]) +
                                          (int64_t)h2 * (r * sprite_ref[2][0] - 16LL * vop_ref[2][0]),
                                      h);
    virtual_ref[1][1] = 16 * (vop_ref[0][1] + h2) +
                        rounded_div64((int64_t)(h - h2) * (r * sprite_ref[0][1] - 16LL * vop_ref[0][1]) +
                                          (int64_t)h2 * (r * sprite_ref[2][1] - 16LL * vop_ref[2][1]),
                                      h);
    const int min_ab = std::min(alpha, beta);
    const int64_t w3 = w2 >> min_ab, h3 = h2 >> min_ab;
    const int shift0 = alpha + beta + rho - min_ab;
    int64_t offset[2][2], delta[2][2];
    offset[0][0] = ((int64_t)sprite_ref[0][0] << shift0) +
                   (-r * (int64_t)sprite_ref[0][0] + virtual_ref[0][0]) * h3 * (-vop_ref[0][0]) +
                   (-r * (int64_t)sprite_ref[0][0] + virtual_ref[1][0]) * w3 * (-vop_ref[0][1]) +
                   ((int64_t)1 << (shift0 - 1));
    offset[0][1] = ((int64_t)sprite_ref[0][1] << shift0) +
                   (-r * (int64_t)sprite_ref[0][1] + virtual_ref[0][1]) * h3 * (-vop_ref[0][0]) +
                   (-r * (int64_t)sprite_ref[0][1] + virtual_ref[1][1]) * w3 * (-vop_ref[0][1]) +
                   ((int64_t)1 << (shift0 - 1));
    offset[1][0] = (-r * (int64_t)sprite_ref[0][0] + virtual_ref[0][0]) * h3 * (-2 * vop_ref[0][0] + 1) +
                   (-r * (int64_t)sprite_ref[0][0] + virtual_ref[1][0]) * w3 * (-2 * vop_ref[0][1] + 1) +
                   2 * w2 * h3 * r * (int64_t)sprite_ref[0][0] - 16 * w2 * h3 +
                   ((int64_t)1 << (shift0 + 1));
    offset[1][1] = (-r * (int64_t)sprite_ref[0][1] + virtual_ref[0][1]) * h3 * (-2 * vop_ref[0][0] + 1) +
                   (-r * (int64_t)sprite_ref[0][1] + virtual_ref[1][1]) * w3 * (-2 * vop_ref[0][1] + 1) +
                   2 * w2 * h3 * r * (int64_t)sprite_ref[0][1] - 16 * w2 * h3 +
                   ((int64_t)1 << (shift0 + 1));
    delta[0][0] = (-r * (int64_t)sprite_ref[0][0] + virtual_ref[0][0]) * h3;
    delta[0][1] = (-r * (int64_t)sprite_ref[0][0] + virtual_ref[1][0]) * w3;
    delta[1][0] = (-r * (int64_t)sprite_ref[0][1] + virtual_ref[0][1]) * h3;
    delta[1][1] = (-r * (int64_t)sprite_ref[0][1] + virtual_ref[1][1]) * w3;
    int shift[2] = {shift0, shift0 + 2};
    if (delta[0][0] == ((int64_t)a << shift[0]) && delta[0][1] == 0 && delta[1][0] == 0 &&
        delta[1][1] == ((int64_t)a << shift[0])) {
      offset[0][0] >>= shift[0];
      offset[0][1] >>= shift[0];
      offset[1][0] >>= shift[1];
      offset[1][1] >>= shift[1];
      delta[0][0] = a;
      delta[0][1] = delta[1][0] = 0;
      delta[1][1] = a;
      shift[0] = shift[1] = 0;
      real_warping_points_ = 1;
    } else {
      const int shift_y = 16 - shift[0], shift_c = 16 - shift[1];
      for (int i = 0; i < 2; i++)
        if (shift_c < 0 || shift_y < 0 || std::llabs(offset[0][i]) >= (INT32_MAX >> shift_y) ||
            std::llabs(offset[1][i]) >= (INT32_MAX >> shift_c) ||
            std::llabs(delta[0][i]) >= (INT32_MAX >> shift_y) ||
            std::llabs(delta[1][i]) >= (INT32_MAX >> shift_y))
          unsupported("a GMC warp beyond FFmpeg's 32-bit range");
      for (int i = 0; i < 2; i++) {
        offset[0][i] *= (int64_t)1 << shift_y;
        offset[1][i] *= (int64_t)1 << shift_c;
        delta[0][i] *= (int64_t)1 << shift_y;
        delta[1][i] *= (int64_t)1 << shift_y;
        shift[i] = 16;
      }
      real_warping_points_ = vol.warping_points;
    }
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++) {
        sprite_offset_[i][j] = (int)offset[i][j];
        sprite_delta_[i][j] = (int)delta[i][j];
      }
    sprite_shift_[0] = shift[0];
    sprite_shift_[1] = shift[1];
  }

  // FFmpeg's get_amv: the average motion vector of the MB's GMC warp (what
  // a GMC MB leaves for its neighbours' prediction and for direct mode).
  int get_amv(int n) const {
    const int len = 1 << (fcode_ + 4), a = vol.warping_accuracy;
    // FFmpeg's RSHIFT: rounded, halves toward plus infinity above zero
    // and toward minus infinity below.
    auto rshift = [](int v, int b) {
      return v > 0 ? (v + ((1 << b) >> 1)) >> b : (v + ((1 << b) >> 1) - 1) >> b;
    };
    int sum;
    if (real_warping_points_ == 1) {
      sum = rshift(sprite_offset_[0][n] * (1 << vol.quarter_sample), a);
    } else {
      int dx = sprite_delta_[n][0], dy = sprite_delta_[n][1];
      const int shift = sprite_shift_[0];
      if (n)
        dy -= 1 << (shift + a + 1);
      else
        dx -= 1 << (shift + a + 1);
      unsigned mb_v = (unsigned)sprite_offset_[0][n] + (unsigned)dx * mb_x_ * 16u + (unsigned)dy * mb_y_ * 16u;
      sum = 0;
      for (int y = 0; y < 16; y++) {
        unsigned v = mb_v + (unsigned)dy * y;
        for (int x = 0; x < 16; x++) {
          sum += (int)v >> shift;
          v += dx;
        }
      }
      sum = rshift(sum, a + 8 - vol.quarter_sample);
    }
    if (sum < -len) sum = -len;
    else if (sum >= len) sum = len - 1;
    return sum;
  }

  // Decodes one VOP; false if FFmpeg outputs nothing for it and keeps no
  // picture (not coded, or a B-VOP it skips).
  bool decode_vop(BitReader& br) {
    choose_idct();
    pict_ = (int)br.get(2);
    if (pict_ == 2 && low_delay_ && !vol.control_parameters) low_delay_ = 0;
    int time_incr = 0;
    while (br.get1()) {  // modulo_time_base
      if (br.left() <= 0) corrupt("truncated VOP header");
      time_incr++;
    }
    br.marker("before vop_time_increment");
    const int time_increment = (int)br.get(vol.time_bits);
    br.marker("after vop_time_increment");
    // FFmpeg's VOP times: TRD (pp) and TRB (pb) of direct mode; a B-VOP out
    // of order (after a seek) is skipped.
    if (pict_ != 2) {
      last_time_base_ = time_base_;
      time_base_ += time_incr;
      time_ = time_base_ * vol.time_resolution + time_increment;
      pp_time_ = (uint16_t)(time_ - last_non_b_time_);
      last_non_b_time_ = time_;
    } else {
      time_ = (last_time_base_ + time_incr) * vol.time_resolution + time_increment;
      pb_time_ = (uint16_t)(pp_time_ - (last_non_b_time_ - time_));
      if (pp_time_ <= pb_time_ || pp_time_ <= pp_time_ - pb_time_ || pp_time_ <= 0) {
        stats[kStatBDropped]++;
        return false;
      }
      if (!t_frame_) t_frame_ = pb_time_;
      if (!t_frame_) t_frame_ = 1;
      auto rdiv = [](int64_t a, int64_t b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; };
      pp_field_time_ = (uint16_t)((rdiv(last_non_b_time_, t_frame_) -
                                   rdiv(last_non_b_time_ - pp_time_, t_frame_)) * 2);
      pb_field_time_ = (uint16_t)((rdiv(time_, t_frame_) -
                                   rdiv(last_non_b_time_ - pp_time_, t_frame_)) * 2);
      if (pp_field_time_ <= pb_field_time_ || pb_field_time_ <= 1) {
        pb_field_time_ = 2;
        pp_field_time_ = 4;
        if (vol.interlaced) {
          stats[kStatBDropped]++;
          return false;
        }
      }
    }
    if (!br.get1()) {  // vop_coded 0: no frame; the reference stays
      stats[kStatNotCoded]++;
      skipped_last_ = true;
      return false;
    }
    if (pict_ == 3 && vol.sprite != 2) unsupported("S-VOPs of a stream without GMC");
    rounding_ = pict_ == 1 || pict_ == 3 ? br.get1() : 0;
    dc_threshold_ = kDcThreshold[br.get(3)];
    top_field_first_ = alternate_scan_ = false;
    if (vol.interlaced) {
      top_field_first_ = br.get1();
      alternate_scan_ = br.get1();
    }
    if (pict_ == 3) sprite_trajectory(br);
    int q = (int)br.get(vol.quant_precision);
    if (q == 0) corrupt("vop_quant 0");
    set_qscale(q);
    fcode_ = bcode_ = 1;
    if (pict_ != 0) {
      fcode_ = (int)br.get(3);
      if (!fcode_) corrupt("vop_fcode_forward 0");
    }
    if (pict_ == 2) {
      bcode_ = (int)br.get(3);
      if (!bcode_) corrupt("vop_fcode_backward 0");
    }
    // FFmpeg skips a B-VOP without two anchors (an open GOP's first
    // B-VOPs); a P- or S-VOP without one is refused.
    if (pict_ == 2 && !have_last_) {
      stats[kStatBDropped]++;
      return false;
    }
    if ((pict_ == 1 || pict_ == 3) && !have_next_) corrupt("a P- or S-VOP without a reference");
    stats[pict_ == 0 ? kStatI : pict_ == 1 ? kStatP : pict_ == 2 ? kStatB : kStatS]++;
    pictures++;
    cur_tag_ = vop_tag_;
    interlaced_dct_ = false;
    if (!headers_only) decode_mbs(br);
    if (pict_ == 2) {
      out = &cur_;
      out_tag = cur_tag_;
      return true;
    }
    std::swap(last_, next_);
    std::swap(next_.f, cur_);
    next_.mb.swap(mbi_);
    next_.tag = cur_tag_;
    have_last_ = have_next_;
    have_next_ = true;
    if (low_delay_) {
      out = &next_.f;
      out_tag = next_.tag;
    } else if (have_last_) {
      out = &last_.f;
      out_tag = last_.tag;
    }
    return true;
  }

 public:
  int64_t vop_tag_ = -1;  // the tag of the VOP parse() decodes next

 private:
  int packet_prefix_length() const {
    return pict_ == 0 ? 16 : pict_ == 2 ? 15 + std::max(std::max(fcode_, bcode_), 1) : 15 + fcode_;
  }

  // Whether a resync marker follows the MB just decoded: the stuffing (a
  // zero, then ones to the byte boundary), prefix-length zeros and a one.
  bool at_resync(const BitReader& br) const {
    size_t pos = br.pos();
    size_t aligned = (pos + 8) & ~size_t(7);
    int stuff_bits = (int)(aligned - pos);
    int prefix = packet_prefix_length();
    if (br.size_bits() < aligned + prefix + 1) return false;
    if (br.peek(stuff_bits) != (1u << (stuff_bits - 1)) - 1) return false;
    return br.peek_at(aligned, prefix + 1) == 1u;
  }

  void video_packet_header(BitReader& br) {
    br.skip(1);  // the stuffing
    br.align();
    int zeros = 0;
    while (zeros < 32 && !br.get1()) zeros++;
    if (zeros != packet_prefix_length()) corrupt("bad resync marker");
    int mb_num = (int)br.get(log2_floor(mbw_ * mbh_ - 1) + 1);
    if (mb_num <= 0 || mb_num >= mbw_ * mbh_) corrupt("video packet at MB %d", mb_num);
    mb_x_ = mb_num % mbw_;
    mb_y_ = mb_num / mbw_;
    int q = (int)br.get(vol.quant_precision);
    if (q) set_qscale(q);
    if (br.get1()) {  // header_extension_code
      while (br.get1()) {
        if (br.left() <= 0) corrupt("truncated video packet header");
      }
      br.marker("in a video packet header");
      br.skip(vol.time_bits);
      br.marker("in a video packet header");
      br.skip(2 + 3);  // vop_coding_type, intra_dc_vlc_thr
      if (pict_ == 3) unsupported("a video packet header extension in an S-VOP");
      if (pict_ != 0 && !br.get(3)) corrupt("vop_fcode_forward 0 in a video packet header");
      if (pict_ == 2 && !br.get(3)) corrupt("vop_fcode_backward 0 in a video packet header");
    }
    // FFmpeg's ff_mpeg4_clean_buffers also resets the B-VOP predictors.
    last_mv_[0][0][0] = last_mv_[0][0][1] = last_mv_[1][0][0] = last_mv_[1][0][1] = 0;
  }

  void decode_mbs(BitReader& br) {
    mb_x_ = mb_y_ = 0;
    for (bool first = true;; first = false) {
      if (!first) {
        video_packet_header(br);
        clean_buffers();
      }
      start_packet();
      bool packet_end = false;
      for (; mb_y_ < mbh_; mb_y_++) {
        for (; mb_x_ < mbw_; mb_x_++) {
          if (resync_x_ == mb_x_ && resync_y_ + 1 == mb_y_) first_line_ = false;
          if (pict_ == 2)
            decode_b_mb(br);
          else
            decode_mb(br);
          bool last_mb = mb_x_ + 1 == mbw_ && mb_y_ + 1 == mbh_;
          if (!vol.resync_disable && !last_mb && at_resync(br)) {
            packet_end = true;
            break;
          }
        }
        if (packet_end) break;
        mb_x_ = 0;
      }
      if (!packet_end) return;
    }
  }

  int decode_motion(BitReader& br, int pred, int fcode) {
    int code = br.vlc(tables().mv);
    if (code == 0) return pred;
    int sign = br.get1();
    int shift = fcode - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= (int)br.get(shift);
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int m = 1 << (5 + fcode);  // wrap into [-32 << (fcode - 1), 32 << (fcode - 1))
    return ((val + (m >> 1)) & (m - 1)) - (m >> 1);
  }

  MbInfo& info() { return mbi_[(size_t)mb_y_ * mbw_ + mb_x_]; }

  // FFmpeg's ff_h263_update_motion_val for the MB just decoded of an
  // anchor: its vectors for the neighbours' prediction and for direct mode.
  void keep_motion(const Motion& m, bool intra, bool skipped) {
    MbInfo& mi = info();
    mi = MbInfo();
    mi.skipped = skipped;
    if (intra) {
      mi.kind = kIntraMb;
      set_mvs(0, 0);
      return;
    }
    mi.kind = (uint8_t)m.type;
    if (m.type == k8x8) {
      for (int b = 0; b < 4; b++) {
        mi.mv[b][0] = (int16_t)m.mv[b][0];
        mi.mv[b][1] = (int16_t)m.mv[b][1];
        int16_t* p = mv_at(2 * mb_x_ + (b & 1), 2 * mb_y_ + (b >> 1));
        p[0] = (int16_t)m.mv[b][0];
        p[1] = (int16_t)m.mv[b][1];
      }
      return;
    }
    int mx = m.mv[0][0], my = m.mv[0][1];
    if (m.type == kFieldMb) {
      mx = m.mv[0][0] + m.mv[1][0];
      my = m.mv[0][1] + m.mv[1][1];
      mx = (mx >> 1) | (mx & 1);
      for (int i = 0; i < 2; i++) {
        mi.field_mv[i][0] = (int16_t)m.mv[i][0];
        mi.field_mv[i][1] = (int16_t)m.mv[i][1];
        mi.field_sel[i] = (uint8_t)m.sel[i];
      }
    }
    for (int b = 0; b < 4; b++) {
      mi.mv[b][0] = (int16_t)mx;
      mi.mv[b][1] = (int16_t)my;
    }
    set_mvs(mx, my);
  }

  // P- and S-VOP MBs (and I-VOP ones).
  void decode_mb(BitReader& br) {
    const Tables& t = tables();
    int cbpc, dquant;
    Motion m;
    memset(block_, 0, sizeof block_);
    if (pict_ == 1 || pict_ == 3) {
      do {
        if (br.get1()) {  // not_coded
          st_.qscale[st_.cidx(mb_x_, mb_y_)] = (uint8_t)qscale_;
          clean_intra_entries();
          const bool gmc = pict_ == 3;
          if (gmc) {
            m.type = kGmcMb;
            m.mv[0][0] = get_amv(0);
            m.mv[0][1] = get_amv(1);
            stats[kStatMcsel]++;
          }
          keep_motion(m, false, !gmc);
          for (int n = 0; n < 6; n++) last_index_[n] = -1;
          reconstruct_inter(m, nullptr, rounding_);
          return;
        }
        cbpc = br.vlc(t.inter_mcbpc);
      } while (cbpc == 20);
      dquant = cbpc & 8;
      if (!(cbpc & 4)) {
        mcsel_ = pict_ == 3 && !(cbpc & 16) && br.get1();
        int cbpy = br.vlc(t.cbpy) ^ 0xf;
        int cbp = (cbpc & 3) | (cbpy << 2);
        if (dquant) set_qscale(qscale_ + kQuantDelta[br.get(2)]);
        if (vol.interlaced && cbp) interlaced_dct_ = br.get1();
        if (!(cbpc & 16)) {
          if (mcsel_) {
            m.type = kGmcMb;
            m.mv[0][0] = get_amv(0);
            m.mv[0][1] = get_amv(1);
            stats[kStatMcsel]++;
          } else if (vol.interlaced && br.get1()) {
            m.type = kFieldMb;
            m.sel[0] = br.get1();
            m.sel[1] = br.get1();
            int px, py;
            pred_motion(0, &px, &py);
            for (int i = 0; i < 2; i++) {
              m.mv[i][0] = decode_motion(br, px, fcode_);
              m.mv[i][1] = decode_motion(br, py / 2, fcode_);
            }
            stats[kStatFieldMv]++;
          } else {
            int px, py;
            pred_motion(0, &px, &py);
            m.mv[0][0] = decode_motion(br, px, fcode_);
            m.mv[0][1] = decode_motion(br, py, fcode_);
          }
        } else {
          m.type = k8x8;
          for (int i = 0; i < 4; i++) {
            int px, py;
            pred_motion(i, &px, &py);
            m.mv[i][0] = decode_motion(br, px, fcode_);
            m.mv[i][1] = decode_motion(br, py, fcode_);
            int16_t* p = mv_at(2 * mb_x_ + (i & 1), 2 * mb_y_ + (i >> 1));
            p[0] = (int16_t)m.mv[i][0];
            p[1] = (int16_t)m.mv[i][1];
          }
          stats[kStat4Mv]++;
        }
        for (int i = 0; i < 6; i++)
          decode_block(br, block_[i], i, (cbp >> (5 - i)) & 1, false, false);
        st_.qscale[st_.cidx(mb_x_, mb_y_)] = (uint8_t)qscale_;
        clean_intra_entries();
        keep_motion(m, false, false);
        if (cbp && interlaced_dct_) stats[kStatFieldDct]++;
        reconstruct_inter(m, nullptr, rounding_);
        return;
      }
    } else {
      do {
        cbpc = br.vlc(t.intra_mcbpc);
      } while (cbpc == 8);
      dquant = cbpc & 4;
    }
    // An intra MB.
    ac_pred_ = br.get1();
    int cbpy = br.vlc(t.cbpy);
    int cbp = (cbpc & 3) | (cbpy << 2);
    bool use_dc_vlc = qscale_ < dc_threshold_;  // the running qscale, before dquant
    if (dquant) set_qscale(qscale_ + kQuantDelta[br.get(2)]);
    if (vol.interlaced) interlaced_dct_ = br.get1();
    if (interlaced_dct_) stats[kStatFieldDct]++;
    st_.qscale[st_.cidx(mb_x_, mb_y_)] = (uint8_t)qscale_;
    for (int i = 0; i < 6; i++) decode_block(br, block_[i], i, (cbp >> (5 - i)) & 1, true, use_dc_vlc);
    keep_motion(m, true, false);
    reconstruct_intra();
  }

  // FFmpeg's mpeg4_decode_mb for B-VOPs, then ff_mpeg4_set_direct_mv.
  void decode_b_mb(BitReader& br) {
    memset(block_, 0, sizeof block_);
    if (mb_x_ == 0) memset(last_mv_, 0, sizeof last_mv_);
    const MbInfo& col = next_.mb[(size_t)mb_y_ * mbw_ + mb_x_];
    Motion m[2];
    if (col.skipped) {  // skipped in the anchor after it: a copy of the one before
      for (int n = 0; n < 6; n++) last_index_[n] = -1;
      reconstruct_inter(m[0], nullptr, 0);
      return;
    }
    int cbp = 0, mb_type;  // 0 direct, 1 interpolate, 2 backward, 3 forward
    bool field = false;
    int sel[2][2] = {{0, 0}, {0, 0}};
    if (br.get1()) {  // modb 1: direct, no vectors, no coefficients
      mb_type = -1;
    } else {
      const int modb2 = br.get1();
      mb_type = br.vlc(b_mb_type_vlc());
      if (!modb2) cbp = (int)br.get(6);
      if (mb_type != 0 && cbp && br.get1()) set_qscale(qscale_ + (br.get1() ? 2 : -2));
      if (vol.interlaced) {
        if (cbp) interlaced_dct_ = br.get1();
        if (mb_type != 0 && br.get1()) {
          field = true;
          if (mb_type != 2) {  // forward
            sel[0][0] = br.get1();
            sel[0][1] = br.get1();
          }
          if (mb_type != 3) {  // backward
            sel[1][0] = br.get1();
            sel[1][1] = br.get1();
          }
        }
      }
    }
    bool dirs[2] = {false, false};
    if (mb_type > 0) {
      dirs[0] = mb_type != 2;
      dirs[1] = mb_type != 3;
      for (int d = 0; d < 2; d++) {
        if (!dirs[d]) continue;
        const int code = d ? bcode_ : fcode_;
        if (!field) {
          int mx = decode_motion(br, last_mv_[d][0][0], code);
          int my = decode_motion(br, last_mv_[d][0][1], code);
          last_mv_[d][1][0] = last_mv_[d][0][0] = m[d].mv[0][0] = mx;
          last_mv_[d][1][1] = last_mv_[d][0][1] = m[d].mv[0][1] = my;
        } else {
          m[d].type = kFieldMb;
          for (int i = 0; i < 2; i++) {
            int mx = decode_motion(br, last_mv_[d][i][0], code);
            int my = decode_motion(br, last_mv_[d][i][1] / 2, code);
            last_mv_[d][i][0] = m[d].mv[i][0] = mx;
            m[d].mv[i][1] = my;
            last_mv_[d][i][1] = my * 2;
            m[d].sel[i] = sel[d][i];
          }
          stats[kStatFieldMv]++;
        }
      }
    } else {
      int mx = 0, my = 0;
      if (mb_type == 0) {
        mx = decode_motion(br, 0, 1);
        my = decode_motion(br, 0, 1);
      }
      set_direct_mv(col, mx, my, m);
      dirs[0] = dirs[1] = true;
      stats[kStatDirect]++;
    }
    for (int i = 0; i < 6; i++) decode_block(br, block_[i], i, (cbp >> (5 - i)) & 1, false, false);
    if (cbp && interlaced_dct_) stats[kStatFieldDct]++;
    reconstruct_inter(m[0], dirs[1] ? &m[1] : nullptr, 0, dirs[0]);
  }

  // FFmpeg's ff_mpeg4_set_direct_mv: the co-located MB's vectors scaled by
  // TRB / TRD, plus the delta (mx, my).
  void set_direct_mv(const MbInfo& col, int mx, int my, Motion* m) {
    const int pp = pp_time_, pb = pb_time_;
    auto one = [&](int i, int b) {
      for (int c = 0; c < 2; c++) {
        const int p = col.mv[b][c], delta = c ? my : mx;
        m[0].mv[i][c] = p * pb / pp + delta;
        m[1].mv[i][c] = delta ? m[0].mv[i][c] - p : p * (pb - pp) / pp;
      }
    };
    if (col.kind == k8x8) {
      m[0].type = m[1].type = k8x8;
      for (int i = 0; i < 4; i++) one(i, i);
    } else if (col.kind == kFieldMb) {
      m[0].type = m[1].type = kFieldMb;
      for (int i = 0; i < 2; i++) {
        const int fs = col.field_sel[i];
        m[0].sel[i] = fs;
        m[1].sel[i] = i;
        int tpp, tpb;
        if (top_field_first_) {
          tpp = (uint16_t)(pp_field_time_ - fs + i);
          tpb = (uint16_t)(pb_field_time_ - fs + i);
        } else {
          tpp = (uint16_t)(pp_field_time_ + fs - i);
          tpb = (uint16_t)(pb_field_time_ + fs - i);
        }
        for (int c = 0; c < 2; c++) {
          const int p = col.field_mv[i][c], delta = c ? my : mx;
          m[0].mv[i][c] = p * tpb / tpp + delta;
          m[1].mv[i][c] = delta ? m[0].mv[i][c] - p : p * (tpb - tpp) / tpp;
        }
      }
      stats[kStatDirectField]++;
    } else {
      one(0, 0);
      for (int d = 0; d < 2; d++) {
        for (int i = 1; i < 4; i++) {
          m[d].mv[i][0] = m[d].mv[0][0];
          m[d].mv[i][1] = m[d].mv[0][1];
        }
        m[d].type = vol.quarter_sample ? k8x8 : k16x16;
      }
    }
  }

  // Inter MB: the prediction of one direction (two: their rounded mean),
  // then the residual of the coded blocks.
  void reconstruct_inter(const Motion& m0, const Motion* m1, int rnd, bool forward = true) {
    const Pred p = in_picture();
    if (pict_ == 2 && forward && m1) {
      uint8_t y[256], u[64], v[64];
      predict(last_.f, m0, 0, p);
      predict(next_.f, *m1, 0, Pred{y, u, v, 16, 8});
      for (int r = 0; r < 16; r++)
        for (int c = 0; c < 16; c++) {
          uint8_t& d = p.y[r * p.ys + c];
          d = (uint8_t)((d + y[r * 16 + c] + 1) >> 1);
        }
      for (int r = 0; r < 8; r++)
        for (int c = 0; c < 8; c++) {
          uint8_t& du = p.u[r * p.cs + c];
          uint8_t& dv = p.v[r * p.cs + c];
          du = (uint8_t)((du + u[r * 8 + c] + 1) >> 1);
          dv = (uint8_t)((dv + v[r * 8 + c] + 1) >> 1);
        }
    } else if (pict_ == 2) {
      predict(forward ? last_.f : next_.f, forward ? m0 : *m1, 0, p);
    } else {
      predict(next_.f, m0, rnd, p);
    }
    add_residual();
  }

  // FFmpeg's mpeg4_decode_block: intra blocks keep quantised levels (with
  // their DC and AC predictions); inter blocks are dequantised as read
  // (H.263 quantisation) or after (MPEG quantisation).
  void decode_block(BitReader& br, int16_t* block, int n, bool coded, bool intra, bool use_dc_vlc) {
    const Tables& t = tables();
    int i, dc_dir = 0;
    const uint8_t* scan = alternate_scan_ ? kAltVertical : kZigzag;
    const RunLevelTable* rl;
    const Vlc* vlc;
    int qmul = 1, qadd = 0;
    if (intra) {
      if (use_dc_vlc) {
        int size = br.vlc(n < 4 ? t.dc_lum : t.dc_chrom);
        if (size > 9) corrupt("DC size %d", size);
        int level = 0;
        if (size) {
          int v = (int)br.get(size);
          level = (v >> (size - 1)) ? v : v - (1 << size) + 1;
          if (size > 8) br.marker("after a DC coefficient");
        }
        block[0] = (int16_t)pred_dc(n, level, &dc_dir, false);
        i = 0;
      } else {
        i = -1;
        pred_dc(n, 0, &dc_dir, false);  // the direction; the level comes with the AC
      }
      rl = &t.intra;
      vlc = &t.intra_vlc;
      if (ac_pred_ && !alternate_scan_) scan = dc_dir == 0 ? kAltVertical : kAltHorizontal;
    } else {
      i = -1;
      if (!coded) {
        last_index_[n] = -1;
        return;
      }
      rl = &t.inter;
      vlc = &t.inter_vlc;
      if (!vol.mpeg_quant) {
        qmul = qscale_ << 1;
        qadd = (qscale_ - 1) | 1;
      }
    }
    if (coded) {
      for (;;) {
        int sym = br.vlc(*vlc);
        int last, run, level;
        if (sym == 102) {    // ESCAPE
          if (!br.get1()) {  // type 1: the level less the run's largest
            sym = br.vlc(*vlc);
            if (sym == 102) corrupt("an escape within an escape");
            last = rl->last[sym];
            run = rl->run[sym];
            level = (rl->level[sym] + rl->max_level[last][run]) * qmul + qadd;
            if (br.get1()) level = -level;
          } else if (!br.get1()) {  // type 2: the run less the level's largest, less one
            sym = br.vlc(*vlc);
            if (sym == 102) corrupt("an escape within an escape");
            last = rl->last[sym];
            level = rl->level[sym];
            run = rl->run[sym] + rl->max_run[last][level] + 1;
            level = level * qmul + qadd;
            if (br.get1()) level = -level;
          } else {  // type 3: fixed-length last, run and level
            last = br.get1();
            run = (int)br.get(6);
            br.marker("before an escaped level");
            level = br.sget(12);
            br.marker("after an escaped level");
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            if (level < -2048 || level > 2047) level = level < 0 ? -2048 : 2047;
          }
        } else {
          last = rl->last[sym];
          run = rl->run[sym];
          level = rl->level[sym] * qmul + qadd;
          if (br.get1()) level = -level;
        }
        i += run + 1;
        if (i > 63) corrupt("more than 64 coefficients in a block");
        block[scan[i]] = (int16_t)level;
        if (last) break;
      }
    }
    if (intra) {
      if (!use_dc_vlc) {
        block[0] = (int16_t)pred_dc(n, block[0], &dc_dir, false);
        if (i < 0) i = 0;
      }
      pred_ac(block, n, dc_dir);
      if (ac_pred_) i = 63;
    }
    last_index_[n] = i;
  }
};

// ---------------------------------------------------------------------------
// Encoder

class BitWriter {
 public:
  std::vector<uint8_t> bytes;

  void put(uint32_t value, int bits) {  // bits <= 32
    if (!bits) return;
    acc_ = (acc_ << bits) | (value & (bits == 32 ? 0xffffffffu : ((1u << bits) - 1)));
    n_ += bits;
    while (n_ >= 8) {
      bytes.push_back((uint8_t)(acc_ >> (n_ - 8)));
      n_ -= 8;
    }
    acc_ &= (1ull << n_) - 1;
  }
  // next_start_code(): a zero, then ones to the byte boundary.
  void stuffing() {
    put(0, 1);
    if (n_) put((1u << (8 - n_)) - 1, 8 - n_);
  }
  void start_code(uint8_t code) { put(0x100 | code, 32); }
  size_t bit_count() const { return bytes.size() * 8 + n_; }

 private:
  uint64_t acc_ = 0;
  int n_ = 0;
};

// The orthonormal-scaled forward DCT of MPEG: F(0, 0) is 8 times the mean.
// Two passes of 8x8 products in float (the encoder's own rounding: only
// its reconstruction, through the decoder's IDCT, must be exact).
struct ForwardDct {
  float c[8][8];
  ForwardDct() {
    for (int u = 0; u < 8; u++)
      for (int x = 0; x < 8; x++)
        c[u][x] = (float)((u ? 0.5 : 0.5 / std::sqrt(2.0)) * std::cos((2 * x + 1) * u * M_PI / 16));
  }
  void operator()(const int* f, float* out) const {
    float tmp[64];
    for (int y = 0; y < 8; y++) {
      float row[8];
      for (int x = 0; x < 8; x++) row[x] = (float)f[y * 8 + x];
      for (int u = 0; u < 8; u++) {
        const float* cu = c[u];
        tmp[u * 8 + y] = cu[0] * row[0] + cu[1] * row[1] + cu[2] * row[2] + cu[3] * row[3] +
                         cu[4] * row[4] + cu[5] * row[5] + cu[6] * row[6] + cu[7] * row[7];
      }
    }
    for (int u = 0; u < 8; u++) {
      const float* t = tmp + u * 8;
      for (int v = 0; v < 8; v++) {
        const float* cv = c[v];
        out[v * 8 + u] = cv[0] * t[0] + cv[1] * t[1] + cv[2] * t[2] + cv[3] * t[3] + cv[4] * t[4] +
                         cv[5] * t[5] + cv[6] * t[6] + cv[7] * t[7];
      }
    }
  }
};

const ForwardDct& fdct() {
  static const ForwardDct d;
  return d;
}

// Coding tools the encoder can use beyond what cv2's FFmpeg writes (all
// off by default): they exercise the decoder's remaining paths in streams
// that FFmpeg can judge.
struct Tools {
  bool ac_pred = false;     // per intra MB where it saves bits (FFmpeg's decide_ac_pred)
  bool dquant = false;      // qscale changes by -1, -2, +1, +2 in turn over coded MBs
  bool four_mv = false;     // 4MV where the four 8x8 vectors cost less
  int packet_mbs = 0;       // a video packet (resync marker) every that many MBs
  int dc_threshold = 0;     // intra_dc_vlc_thr: DC through the AC table at qscale >= 13, 15, ...
  int not_coded_every = 0;  // every that many frames a P-VOP with vop_coded 0
};

class Encoder : public Codec {
 public:
  long long frames = 0;
  std::vector<uint8_t> packet;
  bool keyframe = false;
  Tools tools;

  // The last frame as a decoder reconstructs it.
  const Frame& output() const { return ref_; }

  Encoder(int w, int h, int time_resolution, int time_increment, int gop, int q)
      : time_res_(time_resolution), time_inc_(time_increment), gop_(gop), q_(q) {
    init_size(w, h);
    ref_.resize(mbw_, mbh_);
    src_.resize(mbw_, mbh_);
    time_bits_ = std::max(log2_floor(time_res_ - 1) + 1, 1);
    prev_mv_.assign((size_t)mbw_ * mbh_ * 2, 0);
    fcode_ = 2;  // vectors within +-32 pel
  }

  // VOS (Simple Profile), VO and VOL, as FFmpeg writes them: the decoder
  // configuration of MP4 and Matroska, and the head of AVI key frames.
  std::vector<uint8_t> config() const {
    BitWriter bw;
    bw.start_code(0xb0);
    bw.put(0x01, 8);  // profile_and_level_indication: Simple Profile
    bw.start_code(0xb5);
    bw.put(1, 1);  // is_visual_object_identifier
    bw.put(1, 4);  // visual_object_verid
    bw.put(1, 3);  // visual_object_priority
    bw.put(1, 4);  // visual_object_type: video
    bw.put(0, 1);  // video_signal_type
    bw.stuffing();
    bw.start_code(0x00);  // video_object
    bw.start_code(0x20);  // video_object_layer
    bw.put(0, 1);         // random_accessible_vol
    bw.put(1, 8);         // video_object_type_indication: Simple Object
    bw.put(1, 1);         // is_object_layer_identifier
    bw.put(1, 4);         // video_object_layer_verid
    bw.put(1, 3);         // video_object_layer_priority
    bw.put(1, 4);         // aspect_ratio_info: square pixels
    bw.put(1, 1);         // vol_control_parameters
    bw.put(1, 2);         // chroma_format 4:2:0
    bw.put(1, 1);         // low_delay
    bw.put(0, 1);         // vbv_parameters
    bw.put(0, 2);         // rectangular
    bw.put(1, 1);
    bw.put((uint32_t)time_res_, 16);
    bw.put(1, 1);
    bw.put(0, 1);  // fixed_vop_rate
    bw.put(1, 1);
    bw.put((uint32_t)width, 13);
    bw.put(1, 1);
    bw.put((uint32_t)height, 13);
    bw.put(1, 1);
    bw.put(0, 1);  // interlaced
    bw.put(1, 1);  // obmc_disable
    bw.put(0, 1);  // sprite_enable
    bw.put(0, 1);  // not_8_bit
    bw.put(0, 1);  // quant_type: H.263
    bw.put(1, 1);  // complexity_estimation_disable
    bw.put(tools.packet_mbs ? 0 : 1, 1);  // resync_marker_disable
    bw.put(0, 1);  // data_partitioned
    bw.put(0, 1);  // scalability
    bw.stuffing();
    return bw.bytes;
  }

  // Encodes one frame of planes y [h][w], u and v [(h+1)/2][(w+1)/2] into
  // `packet` (a GOV before each I-VOP).
  void encode(const uint8_t* y, const uint8_t* u, const uint8_t* v) {
    load_source(y, u, v);
    keyframe = frames % gop_ == 0;
    bool coded = keyframe || !tools.not_coded_every || frames % tools.not_coded_every;
    pict_ = keyframe ? 0 : 1;
    if (coded) rounding_ = keyframe ? 0 : rounding_ ^ 1;
    set_qscale(q_);
    BitWriter bw;
    long long t = frames * time_inc_;
    long long sec = t / time_res_;
    if (keyframe) {
      bw.start_code(0xb3);  // GOV: the time code of this frame
      bw.put((uint32_t)((sec / 3600) % 24), 5);
      bw.put((uint32_t)((sec / 60) % 60), 6);
      bw.put(1, 1);
      bw.put((uint32_t)(sec % 60), 6);
      bw.put(0, 1);  // closed_gov
      bw.put(0, 1);  // broken_link
      bw.stuffing();
      last_sec_ = sec;
    }
    bw.start_code(0xb6);
    bw.put((uint32_t)pict_, 2);
    for (long long k = last_sec_; k < sec; k++) bw.put(1, 1);  // modulo_time_base
    bw.put(0, 1);
    last_sec_ = sec;
    bw.put(1, 1);
    bw.put((uint32_t)(t % time_res_), time_bits_);
    bw.put(1, 1);
    bw.put(coded ? 1 : 0, 1);  // vop_coded
    if (!coded) {  // the reference repeats
      bw.stuffing();
      packet.swap(bw.bytes);
      frames++;
      return;
    }
    if (pict_ == 1) bw.put((uint32_t)rounding_, 1);
    bw.put((uint32_t)tools.dc_threshold, 3);  // intra_dc_vlc_thr
    dc_threshold_ = kDcThreshold[tools.dc_threshold];
    bw.put((uint32_t)qscale_, 5);
    if (pict_ == 1) bw.put((uint32_t)fcode_, 3);
    mb_x_ = mb_y_ = 0;
    start_packet();
    int mb = 0;
    for (mb_y_ = 0; mb_y_ < mbh_; mb_y_++) {
      for (mb_x_ = 0; mb_x_ < mbw_; mb_x_++, mb++) {
        if (tools.packet_mbs && mb && mb % tools.packet_mbs == 0) put_packet_header(bw, mb);
        if (resync_x_ == mb_x_ && resync_y_ + 1 == mb_y_) first_line_ = false;
        if (pict_ == 0)
          encode_intra_mb(bw, kIntraMcbpc, 0, 4);
        else
          encode_p_mb(bw);
      }
    }
    bw.stuffing();
    std::swap(cur_, ref_);
    packet.swap(bw.bytes);
    frames++;
  }

 private:
  Frame ref_;  // the last frame reconstructed (the reference of the next P-VOP)
  Frame src_;  // the input, replicated to the MB-aligned size
  int time_res_, time_inc_, time_bits_ = 1, gop_, q_;
  int dc_threshold_ = 99;
  long long last_sec_ = 0;
  int dquant_turn_ = 0;
  std::vector<int16_t> prev_mv_;  // per MB, the previous P-VOP's vector

  // A resync marker and video packet header before MB `mb`; the prediction
  // restarts as the decoder restarts it.
  void put_packet_header(BitWriter& bw, int mb) {
    bw.stuffing();
    int prefix = pict_ == 0 ? 16 : 15 + fcode_;
    bw.put(1, prefix + 1);
    bw.put((uint32_t)mb, log2_floor(mbw_ * mbh_ - 1) + 1);
    bw.put((uint32_t)qscale_, 5);
    bw.put(0, 1);  // header_extension_code
    start_packet();
    clean_buffers();
  }

  // The next dquant of the turn, or 0; applies it.
  int take_dquant() {
    if (!tools.dquant) return -1;
    int code = dquant_turn_++ & 3;
    set_qscale(qscale_ + kQuantDelta[code]);
    return code;
  }

  void load_source(const uint8_t* y, const uint8_t* u, const uint8_t* v) {
    const uint8_t* in[3] = {y, u, v};
    for (int c = 0; c < 3; c++) {
      Plane& p = src_.p[c];
      int w = c ? (width + 1) / 2 : width, h = c ? (height + 1) / 2 : height;
      for (int r = 0; r < p.h; r++) {
        const uint8_t* s = in[c] + (size_t)std::min(r, h - 1) * w;
        uint8_t* d = p.row(r);
        memcpy(d, s, w);
        memset(d + w, s[w - 1], p.w - w);
      }
    }
  }

  const uint8_t* src_block(int plane, int n) const {
    if (plane == 0) return src_.p[0].row(mb_y_ * 16 + (n >> 1) * 8) + mb_x_ * 16 + (n & 1) * 8;
    return src_.p[plane].row(mb_y_ * 8) + mb_x_ * 8;
  }
  int stride(int plane) const { return src_.p[plane].w; }

  // Writes one (last, run, level) through the table, its escapes or the
  // fixed-length escape.
  static void put_coef(BitWriter& bw, const RunLevelTable& rl, int last, int run, int level) {
    int sign = level < 0, a = std::abs(level);
    auto code = [&](int l, int r, int lev) -> int {
      return (r < 64 && lev < 32) ? rl.index[l][r][lev] : -1;
    };
    int sym = code(last, run, a);
    if (sym >= 0) {
      bw.put(rl.vlc[sym][0], rl.vlc[sym][1]);
      bw.put((uint32_t)sign, 1);
      return;
    }
    const uint16_t* esc = rl.vlc[102];
    int a1 = a - rl.max_level[last][run];
    sym = a1 > 0 ? code(last, run, a1) : -1;
    if (sym >= 0) {
      bw.put(esc[0], esc[1]);
      bw.put(0, 1);
      bw.put(rl.vlc[sym][0], rl.vlc[sym][1]);
      bw.put((uint32_t)sign, 1);
      return;
    }
    int r2 = a < 64 ? run - rl.max_run[last][a] - 1 : -1;
    sym = r2 >= 0 ? code(last, r2, a) : -1;
    if (sym >= 0) {
      bw.put(esc[0], esc[1]);
      bw.put(2, 2);
      bw.put(rl.vlc[sym][0], rl.vlc[sym][1]);
      bw.put((uint32_t)sign, 1);
      return;
    }
    bw.put(esc[0], esc[1]);
    bw.put(3, 2);
    bw.put((uint32_t)last, 1);
    bw.put((uint32_t)run, 6);
    bw.put(1, 1);
    bw.put((uint32_t)level & 0xfff, 12);
    bw.put(1, 1);
  }

  // The coefficients of `levels` (natural order) from position `start` of
  // `scan`.
  static void put_block(BitWriter& bw, const RunLevelTable& rl, const int16_t* levels, int start,
                        const uint8_t* scan = kZigzag) {
    int last_pos = -1;
    for (int i = 63; i >= start; i--)
      if (levels[scan[i]]) {
        last_pos = i;
        break;
      }
    int run = 0;
    for (int i = start; i <= last_pos; i++) {
      int level = levels[scan[i]];
      if (!level) {
        run++;
        continue;
      }
      put_coef(bw, rl, i == last_pos, run, level);
      run = 0;
    }
  }

  static void put_dc(BitWriter& bw, int n, int diff) {
    int a = std::abs(diff), size = 0;
    while (a >> size) size++;
    const uint8_t* t = n < 4 ? kDcLum[size] : kDcChrom[size];
    bw.put(t[0], t[1]);
    if (size) {
      bw.put((uint32_t)(diff > 0 ? diff : diff + (1 << size) - 1), size);
      if (size > 8) bw.put(1, 1);
    }
  }

  // Quantises an intra MB into block_ (levels, DC prediction taken, the
  // AC predictors kept) and returns, per block, the DC differential.
  void quantise_intra(int* diffs, int* dirs) {
    float coef[64];
    int px[64];
    const float inv_step = 1.0f / (2 * qscale_);
    for (int n = 0; n < 6; n++) {
      int plane = n < 4 ? 0 : n - 3;
      const uint8_t* s = src_block(plane, n);
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) px[y * 8 + x] = s[y * stride(plane) + x];
      fdct()(px, coef);
      int16_t* b = block_[n];
      int scale = n < 4 ? y_dc_ : c_dc_;
      b[0] = (int16_t)std::min(std::max((int)std::lround(coef[0] / scale), 0), 2047 / scale);
      for (int k = 1; k < 64; k++) {
        int l = std::min((int)(std::fabs(coef[k]) * inv_step), 2047);
        b[k] = (int16_t)(coef[k] < 0 ? -l : l);
      }
      diffs[n] = pred_dc(n, b[0], &dirs[n], true);
    }
  }

  // Codes an intra MB (MCBPC from `mcbpc`, whose intra symbols start at
  // `base` and intra+q ones `q_offset` after); reconstructs it as the
  // decoder does.
  void encode_intra_mb(BitWriter& bw, const uint8_t (*mcbpc)[2], int base, int q_offset) {
    const bool use_dc_vlc = qscale_ < dc_threshold_;  // the running qscale
    const int dquant = take_dquant();
    int diffs[6], dirs[6];
    quantise_intra(diffs, dirs);
    st_.qscale[st_.cidx(mb_x_, mb_y_)] = (uint8_t)qscale_;
    // The coded levels: with ac_pred, the first row or column less its
    // prediction, where that costs less over the MB. Each block keeps its
    // levels for the next as it goes, as the decoder keeps them.
    int16_t coded[6][64];
    int gain = 0;
    ac_pred_ = false;
    for (int n = 0; n < 6; n++) {
      memcpy(coded[n], block_[n], sizeof coded[n]);
      if (tools.ac_pred) {
        int pred[8], pos[8];
        ac_prediction(n, dirs[n], pred, pos);
        for (int i = 1; i < 8; i++) {
          int c = block_[n][pos[i]] - pred[i];
          gain += std::abs(block_[n][pos[i]]) - std::abs(c);
          coded[n][pos[i]] = (int16_t)c;
        }
      }
      pred_ac(block_[n], n, dirs[n]);
    }
    ac_pred_ = tools.ac_pred && gain > 0;
    int cbp = 0;
    for (int n = 0; n < 6; n++) {
      const int16_t* c = ac_pred_ ? coded[n] : block_[n];
      bool any = !use_dc_vlc && diffs[n];
      for (int k = 1; k < 64 && !any; k++) any = c[k] != 0;
      if (any) cbp |= 1 << (5 - n);
    }
    int symbol = base + (dquant >= 0 ? q_offset : 0) + (cbp & 3), cbpy = cbp >> 2;
    bw.put(mcbpc[symbol][0], mcbpc[symbol][1]);
    bw.put(ac_pred_ ? 1 : 0, 1);
    bw.put(kCbpy[cbpy][0], kCbpy[cbpy][1]);
    if (dquant >= 0) bw.put((uint32_t)dquant, 2);
    for (int n = 0; n < 6; n++) {
      const int16_t* c = ac_pred_ ? coded[n] : block_[n];
      const uint8_t* scan = !ac_pred_ ? kZigzag : dirs[n] == 0 ? kAltVertical : kAltHorizontal;
      if (use_dc_vlc) {
        put_dc(bw, n, diffs[n]);
        if (cbp & (1 << (5 - n))) put_block(bw, tables().intra, c, 1, scan);
      } else {
        int16_t with_dc[64];
        memcpy(with_dc, c, sizeof with_dc);
        with_dc[0] = (int16_t)diffs[n];
        if (cbp & (1 << (5 - n))) put_block(bw, tables().intra, with_dc, 0, scan);
      }
    }
    set_mvs(0, 0);
    reconstruct_intra();
  }

  // The SAD of the 16x16 luma prediction at half-pel vector (mx, my).
  int sad(int mx, int my, int limit) {
    uint8_t pred[256];
    int dxy = ((my & 1) << 1) | (mx & 1);
    hpel_block(ref_.p[0], mb_x_ * 16 + (mx >> 1), mb_y_ * 16 + (my >> 1), 1, 0, dxy, 16, 16,
               rounding_, pred, 16);
    const uint8_t* s = src_block(0, 0);
    int total = 0;
    for (int y = 0; y < 16; y++) {
      for (int x = 0; x < 16; x++) total += std::abs(s[y * stride(0) + x] - pred[y * 16 + x]);
      if (total >= limit) return total;
    }
    return total;
  }

  static int mv_bits(int d) {
    if (!d) return 1;
    int a = std::abs(d) - 1;
    return kMv[std::min((a >> 1) + 1, 32)][1] + 2;
  }

  // The SAD of 8x8 luma block `n` predicted at half-pel vector (mx, my).
  int sad8(int n, int mx, int my) {
    uint8_t pred[64];
    int dxy = ((my & 1) << 1) | (mx & 1);
    hpel_block(ref_.p[0], mb_x_ * 16 + (n & 1) * 8 + (mx >> 1),
               mb_y_ * 16 + (n >> 1) * 8 + (my >> 1), 1, 0, dxy, 8, 8, rounding_, pred, 8);
    const uint8_t* s = src_block(0, n);
    int total = 0;
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) total += std::abs(s[y * stride(0) + x] - pred[y * 8 + x]);
    return total;
  }

  // The residual of the prediction in cur_, quantised as H.263 inter (a
  // dead zone of a quarter step) into levels and, dequantised as the
  // decoder holds them, into block_; returns the cbp.
  int quantise_inter(int16_t (*levels)[64]) {
    const int qmul = qscale_ << 1, qadd = (qscale_ - 1) | 1;
    const int max_level = (2047 - qadd) / qmul;
    int cbp = 0;
    for (int n = 0; n < 6; n++) {
      int plane = n < 4 ? 0 : n - 3;
      const uint8_t* src = src_block(plane, n);
      const uint8_t* pred = dest(plane, n);
      int res[64];
      float coef[64];
      int energy = 0;
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          res[y * 8 + x] = src[y * stride(plane) + x] - pred[y * cur_.p[plane].w + x];
          energy += std::abs(res[y * 8 + x]);
        }
      memset(levels[n], 0, sizeof levels[n]);
      memset(block_[n], 0, sizeof block_[n]);
      last_index_[n] = -1;
      // |F(u, v)| <= sum |res| / 4: below 4 (2 Q + Q / 2) every level is 0.
      if (energy * 2 < 4 * (4 * qscale_ + qscale_)) continue;
      fdct()(res, coef);
      const float inv_step = 1.0f / qmul, dead = qscale_ / 2.0f;
      for (int k = 0; k < 64; k++) {
        int l = std::min(std::max((int)((std::fabs(coef[k]) - dead) * inv_step), 0), max_level);
        if (!l) continue;
        levels[n][k] = (int16_t)(coef[k] < 0 ? -l : l);
        block_[n][k] = (int16_t)(coef[k] < 0 ? -(l * qmul + qadd) : l * qmul + qadd);
        last_index_[n] = 63;
      }
      if (last_index_[n] >= 0) cbp |= 1 << (5 - n);
    }
    return cbp;
  }

  void encode_p_mb(BitWriter& bw) {
    int px, py;
    pred_motion(0, &px, &py);
    const int range = 32 << (fcode_ - 1);  // half-pel vectors lie in [-range, range)
    const int lambda = 2 * qscale_;
    auto cost_of = [&](int mx, int my, int limit) {
      int bits = mv_bits(mx - px) + mv_bits(my - py);
      return sad(mx, my, limit) + lambda * bits;
    };
    auto in_range = [&](int mx, int my) {
      return mx >= -range && mx < range && my >= -range && my < range;
    };
    // Full-pel candidates: zero, the predictor, the neighbours, the last frame's.
    int best_x = 0, best_y = 0, best = cost_of(0, 0, 1 << 30);
    auto consider = [&](int mx, int my) {
      mx &= ~1;
      my &= ~1;
      if (!in_range(mx, my) || (mx == best_x && my == best_y)) return false;
      int c = cost_of(mx, my, best);
      if (c < best) {
        best = c;
        best_x = mx;
        best_y = my;
        return true;
      }
      return false;
    };
    consider(px, py);
    const int16_t* left = mv_at(2 * mb_x_ - 1, 2 * mb_y_);
    consider(left[0], left[1]);
    if (mb_y_ > 0) {
      const int16_t* top = mv_at(2 * mb_x_, 2 * mb_y_ - 1);
      consider(top[0], top[1]);
      const int16_t* tr = mv_at(2 * mb_x_ + 2, 2 * mb_y_ - 1);
      consider(tr[0], tr[1]);
    }
    const int16_t* prev = &prev_mv_[((size_t)mb_y_ * mbw_ + mb_x_) * 2];
    consider(prev[0], prev[1]);
    // A diamond of one pel, then the eight half-pel neighbours.
    for (int step = 0; step < 32; step++) {
      int cx = best_x, cy = best_y;
      bool moved = false;
      static const int dirs[4][2] = {{2, 0}, {-2, 0}, {0, 2}, {0, -2}};
      for (auto& d : dirs) moved |= consider(cx + d[0], cy + d[1]);
      if (!moved) break;
    }
    int fx = best_x, fy = best_y;
    for (int dy = -1; dy <= 1; dy++)
      for (int dx = -1; dx <= 1; dx++) {
        int mx = fx + dx, my = fy + dy;
        if ((!dx && !dy) || !in_range(mx, my)) continue;
        int c = cost_of(mx, my, best);
        if (c < best) {
          best = c;
          best_x = mx;
          best_y = my;
        }
      }
    // Intra where the MB's deviation from its mean is well below the best
    // prediction's error (FFmpeg's simple mb decision).
    const uint8_t* s = src_block(0, 0);
    int sum = 0;
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++) sum += s[y * stride(0) + x];
    int mean = (sum + 128) >> 8, dev = 0;
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++) dev += std::abs(s[y * stride(0) + x] - mean);
    int16_t* pm = &prev_mv_[((size_t)mb_y_ * mbw_ + mb_x_) * 2];
    int best_sad = best - lambda * (mv_bits(best_x - px) + mv_bits(best_y - py));
    if (dev + 500 < best_sad) {
      pm[0] = pm[1] = 0;
      bw.put(0, 1);  // coded
      encode_intra_mb(bw, kInterMcbpc, 4, 8);
      return;
    }
    pm[0] = (int16_t)best_x;
    pm[1] = (int16_t)best_y;
    // 4MV: each 8x8 block refined by half a pel around the MB's vector.
    int mvs[4][2] = {{best_x, best_y}, {best_x, best_y}, {best_x, best_y}, {best_x, best_y}};
    bool four = false;
    if (tools.four_mv) {
      int total = 0;
      for (int n = 0; n < 4; n++) {
        int bsad = sad8(n, best_x, best_y);
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++) {
            int mx = best_x + dx, my = best_y + dy;
            if ((!dx && !dy) || !in_range(mx, my)) continue;
            int c = sad8(n, mx, my);
            if (c < bsad) {
              bsad = c;
              mvs[n][0] = mx;
              mvs[n][1] = my;
            }
          }
        total += bsad;
      }
      four = total + 3 * lambda * 4 < best_sad;
      if (!four)
        for (auto& mv : mvs) mv[0] = best_x, mv[1] = best_y;
    }
    Motion m;
    m.type = four ? k8x8 : k16x16;
    memcpy(m.mv, mvs, sizeof m.mv);
    predict(ref_, m, rounding_, in_picture());
    int16_t levels[6][64];
    int cbp = quantise_inter(levels);
    st_.qscale[st_.cidx(mb_x_, mb_y_)] = (uint8_t)qscale_;
    clean_intra_entries();
    if (!cbp && !four && !best_x && !best_y) {
      bw.put(1, 1);  // not_coded
      set_mvs(0, 0);
      return;
    }
    int dquant = four ? -1 : take_dquant();
    if (dquant >= 0) {  // requantised at the new qscale
      cbp = quantise_inter(levels);
      st_.qscale[st_.cidx(mb_x_, mb_y_)] = (uint8_t)qscale_;
    }
    int symbol = (four ? 16 : dquant >= 0 ? 8 : 0) + (cbp & 3), cbpy = (cbp >> 2) ^ 0xf;
    bw.put(0, 1);
    bw.put(kInterMcbpc[symbol][0], kInterMcbpc[symbol][1]);
    bw.put(kCbpy[cbpy][0], kCbpy[cbpy][1]);
    if (dquant >= 0) bw.put((uint32_t)dquant, 2);
    if (four) {
      for (int n = 0; n < 4; n++) {
        int bx, by;
        pred_motion(n, &bx, &by);
        put_motion(bw, mvs[n][0] - bx);
        put_motion(bw, mvs[n][1] - by);
        int16_t* p = mv_at(2 * mb_x_ + (n & 1), 2 * mb_y_ + (n >> 1));
        p[0] = (int16_t)mvs[n][0];
        p[1] = (int16_t)mvs[n][1];
      }
    } else {
      put_motion(bw, best_x - px);
      put_motion(bw, best_y - py);
      set_mvs(best_x, best_y);
    }
    for (int n = 0; n < 6; n++)
      if (cbp & (1 << (5 - n))) put_block(bw, tables().inter, levels[n], 0);
    add_residual();
  }

  // FFmpeg's ff_h263_encode_motion: the difference wrapped into the f_code range.
  void put_motion(BitWriter& bw, int val) {
    if (!val) {
      bw.put(1, 1);
      return;
    }
    int bit_size = fcode_ - 1;
    int m = 1 << (6 + bit_size);
    val = ((val + (m >> 1)) & (m - 1)) - (m >> 1);
    int sign = val < 0;
    val = std::abs(val) - 1;
    int code = (val >> bit_size) + 1;
    bw.put(((uint32_t)kMv[code][0] << 1) | (uint32_t)sign, kMv[code][1] + 1);
    if (bit_size) bw.put((uint32_t)(val & ((1 << bit_size) - 1)), bit_size);
  }
};

// ---------------------------------------------------------------------------
// Colour: BT.601 limited range, as swscale converts for cv2.

void rgb_to_yuv420(const uint8_t* rgb, int w, int h, uint8_t* y, uint8_t* u, uint8_t* v) {
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++) {
      const uint8_t* p = rgb + ((size_t)r * w + c) * 3;
      y[(size_t)r * w + c] = (uint8_t)(((66 * p[0] + 129 * p[1] + 25 * p[2] + 128) >> 8) + 16);
    }
  int cw = (w + 1) / 2, ch = (h + 1) / 2;
  for (int r = 0; r < ch; r++)
    for (int c = 0; c < cw; c++) {
      int sum[3] = {0, 0, 0};  // the 2x2 mean, edges repeated
      for (int dy = 0; dy < 2; dy++)
        for (int dx = 0; dx < 2; dx++) {
          int rr = std::min(2 * r + dy, h - 1), cc = std::min(2 * c + dx, w - 1);
          const uint8_t* p = rgb + ((size_t)rr * w + cc) * 3;
          for (int k = 0; k < 3; k++) sum[k] += p[k];
        }
      int R = (sum[0] + 2) / 4, G = (sum[1] + 2) / 4, B = (sum[2] + 2) / 4;
      u[(size_t)r * cw + c] = (uint8_t)(((-38 * R - 74 * G + 112 * B + 128) >> 8) + 128);
      v[(size_t)r * cw + c] = (uint8_t)(((112 * R - 94 * G - 18 * B + 128) >> 8) + 128);
    }
}

int fail(const Failure& f, char* err, int err_len) {
  if (err && err_len > 0) snprintf(err, (size_t)err_len, "%s", f.message.c_str());
  return f.code;
}

void copy_planes(const Frame& f, int w, int h, uint8_t* y, uint8_t* u, uint8_t* v) {
  int cw = (w + 1) / 2, ch = (h + 1) / 2;
  for (int r = 0; r < h; r++) memcpy(y + (size_t)r * w, f.p[0].row(r), w);
  for (int r = 0; r < ch; r++) {
    memcpy(u + (size_t)r * cw, f.p[1].row(r), cw);
    memcpy(v + (size_t)r * cw, f.p[2].row(r), cw);
  }
}

}  // namespace

extern "C" {

void* metrabs_mp4v_decoder_new() { return new Decoder(); }

void metrabs_mp4v_decoder_free(void* d) { delete static_cast<Decoder*>(d); }

// The decoder reads headers and orders frames without decoding MBs.
void metrabs_mp4v_decoder_headers_only(void* d) { static_cast<Decoder*>(d)->headers_only = true; }

// The AVI FourCC of the stream, which FFmpeg reads for encoder workarounds.
void metrabs_mp4v_decoder_fourcc(void* d, const char* fourcc) {
  static_cast<Decoder*>(d)->fourcc = fourcc ? fourcc : "";
}

// Reads the VOL of a decoder configuration (MP4's esds, Matroska's
// CodecPrivate, AVI's strf extra bytes) or of a packet that carries it.
int metrabs_mp4v_decoder_config(void* d, const uint8_t* data, size_t n, int* width, int* height,
                                char* err, int err_len) {
  Decoder* dec = static_cast<Decoder*>(d);
  try {
    dec->header(data, n);
  } catch (const Failure& f) {
    return fail(f, err, err_len);
  }
  if (!dec->vol.valid) return kNoFrame;
  *width = dec->vol.width;
  *height = dec->vol.height;
  return kOk;
}

// The container's matrix_coefficients and full-range flag (an MP4 colr box).
void metrabs_mp4v_decoder_colour(void* d, int matrix, int full_range) {
  static_cast<Decoder*>(d)->matrix = matrix;
  static_cast<Decoder*>(d)->full_range = full_range;
}

// Decodes one packet (`tag`: its index, which the frames it yields carry
// as tag * 4 + the VOP's place in it); the frame it outputs, if any, waits
// for metrabs_mp4v_next and metrabs_mp4v_frame. n 0: the end of the stream.
int metrabs_mp4v_decode(void* d, const uint8_t* data, size_t n, int64_t tag, char* err,
                        int err_len) {
  Decoder* dec = static_cast<Decoder*>(d);
  try {
    if (n)
      dec->decode(data, n, tag);
    else
      dec->flush();
  } catch (const Failure& f) {
    dec->out = nullptr;
    return fail(f, err, err_len);
  }
  return kOk;
}

// 1 and the frame's tag if a frame waits.
int metrabs_mp4v_next(void* d, int64_t* tag) {
  Decoder* dec = static_cast<Decoder*>(d);
  if (!dec->out) return 0;
  *tag = dec->out_tag;
  return 1;
}

// The waiting frame into RGB [h][w][3]
// and its planes into y, u and v ([(h + 1) / 2][(w + 1) / 2]), each if not
// null; the waiting frame is taken.
int metrabs_mp4v_frame(void* d, uint8_t* rgb, uint8_t* y, uint8_t* u, uint8_t* v, char* err,
                       int err_len) {
  Decoder* dec = static_cast<Decoder*>(d);
  const Frame* f = dec->out;
  dec->out = nullptr;
  if (!f) return fail(Failure{kNoFrame, "no frame"}, err, err_len);
  if (!rgb && !y && !u) return kOk;
  int w = dec->width, h = dec->height;
  if (!yuv_rgb::supported(h))
    return fail(Failure{kUnsupported, "RGB frames of an odd height below 9 rows"}, err, err_len);
  if (dec->matrix == 0 || dec->matrix == 8 || dec->matrix > 10) {
    char what[96];
    snprintf(what, sizeof what, "RGB of matrix_coefficients %d (GBR, YCgCo and above 10)", dec->matrix);
    return fail(Failure{kUnsupported, what}, err, err_len);
  }
  std::vector<uint8_t> planes((size_t)w * h + 2 * (size_t)((w + 1) / 2) * ((h + 1) / 2));
  uint8_t* py = planes.data();
  uint8_t* pu = py + (size_t)w * h;
  uint8_t* pv = pu + (size_t)((w + 1) / 2) * ((h + 1) / 2);
  copy_planes(*f, w, h, py, pu, pv);
  if (rgb) yuv_rgb::to_rgb(py, w, pu, pv, (w + 1) / 2, w, h, dec->full_range, dec->matrix, 8, rgb);
  if (y) memcpy(y, py, (size_t)w * h);
  if (u) memcpy(u, pu, (size_t)((w + 1) / 2) * ((h + 1) / 2));
  if (v) memcpy(v, pv, (size_t)((w + 1) / 2) * ((h + 1) / 2));
  return kOk;
}

// How many VOPs the decoder has decoded (or parsed, headers only).
int metrabs_mp4v_pictures(void* d) { return static_cast<Decoder*>(d)->pictures; }

// The counts of the decoder's Stat kinds (n of them at most).
void metrabs_mp4v_stats(void* d, int64_t* out, int n) {
  Decoder* dec = static_cast<Decoder*>(d);
  for (int i = 0; i < n && i < kStatCount; i++) out[i] = dec->stats[i];
}

// 1 if two decoders at the same packet go on alike: the same stored VOP and
// the same anchors.
int metrabs_mp4v_state_equal(void* a, void* b) {
  return static_cast<Decoder*>(a)->state_equal(*static_cast<Decoder*>(b));
}

// 1 if a packed stream's VOP waits for the next packet.
int metrabs_mp4v_pending(void* d) { return static_cast<Decoder*>(d)->pending(); }

void* metrabs_mp4v_encoder_new(int width, int height, int time_resolution, int time_increment,
                               int gop, int qscale) {
  if (width <= 0 || height <= 0 || width >= 8192 || height >= 8192 || time_resolution <= 0 ||
      time_resolution > 65535 || time_increment <= 0 || gop <= 0 || qscale < 1 || qscale > 31)
    return nullptr;
  return new Encoder(width, height, time_resolution, time_increment, gop, qscale);
}

void metrabs_mp4v_encoder_free(void* e) { delete static_cast<Encoder*>(e); }

// The coding tools beyond cv2's stream (Tools); before the first frame.
void metrabs_mp4v_encoder_tools(void* e, int ac_pred, int dquant, int four_mv, int packet_mbs,
                                int dc_threshold, int not_coded_every) {
  Tools& t = static_cast<Encoder*>(e)->tools;
  t.ac_pred = ac_pred;
  t.dquant = dquant;
  t.four_mv = four_mv;
  t.packet_mbs = std::max(packet_mbs, 0);
  t.dc_threshold = std::min(std::max(dc_threshold, 0), 7);
  t.not_coded_every = std::max(not_coded_every, 0);
}

// The VOS, VO and VOL headers into out (at most cap bytes); their length.
int metrabs_mp4v_encoder_config(void* e, uint8_t* out, int cap) {
  std::vector<uint8_t> c = static_cast<Encoder*>(e)->config();
  if ((int)c.size() > cap) return -(int)c.size();
  memcpy(out, c.data(), c.size());
  return (int)c.size();
}

// Encodes one RGB [h][w][3] frame; *data and *size hold the packet until
// the next call; *key is 1 for an I-VOP.
int metrabs_mp4v_encode(void* e, const uint8_t* rgb, const uint8_t** data, size_t* size, int* key) {
  Encoder* enc = static_cast<Encoder*>(e);
  int w = enc->width, h = enc->height;
  std::vector<uint8_t> planes((size_t)w * h + 2 * (size_t)((w + 1) / 2) * ((h + 1) / 2));
  uint8_t* y = planes.data();
  uint8_t* u = y + (size_t)w * h;
  uint8_t* v = u + (size_t)((w + 1) / 2) * ((h + 1) / 2);
  rgb_to_yuv420(rgb, w, h, y, u, v);
  enc->encode(y, u, v);
  *data = enc->packet.data();
  *size = enc->packet.size();
  *key = enc->keyframe;
  return kOk;
}

// The encoder's reconstruction of its last frame (what a decoder gives).
void metrabs_mp4v_encoder_recon(void* e, uint8_t* y, uint8_t* u, uint8_t* v) {
  Encoder* enc = static_cast<Encoder*>(e);
  copy_planes(enc->output(), enc->width, enc->height, y, u, v);
}

}  // extern "C"
