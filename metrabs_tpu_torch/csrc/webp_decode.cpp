// Host WebP decoder with the numbers of libwebp's decode as cv2.imread gets
// it (WebPDecodeBGRInto: RGB without alpha, fancy upsampling, no dithering):
// a VP8L (lossless) decoder and a VP8 key-frame (lossy) decoder.
//
// VP8L: prefix codes (simple and normal, code-length codes with repeats),
// meta prefix codes, the colour cache, LZ77 backward references with the
// 120-entry distance map, and the four transforms (predictor with its 14
// modes, cross-colour, subtract-green, colour indexing with pixel packing),
// undone in reverse order. Lossless is exact by definition.
//
// VP8 (RFC 6386, intra only, as WebP is): the boolean decoder as libwebp
// reads it, the frame header (segmentation with absolute values, up to 8
// token partitions, quantiser deltas, token-probability updates, skip
// probability; libvpx's relative segment values and non-zero loop-filter
// deltas, which libwebp's encoder never writes, are refused by name), 16x16,
// 4x4 and chroma intra prediction with libwebp's edge samples (127 above,
// 129 to the left), coefficient tokens with their contexts, dequantisation
// as int16, the inverse WHT and DCT, then the simple or normal loop filter
// over the whole frame (per-segment levels, sharpness), and finally
// libwebp's fancy upsampling of the chroma with its 14-bit fixed-point YUV
// to RGB.
//
// Plain C interface for ctypes:
//   metrabs_webp_decode(data, size, lossless, width, height, out, err, n)
// decodes one VP8 (`lossless` 0) or VP8L (1) chunk payload of width x height
// into `out` (height x width x 3, RGB) and returns 0, 1 for a corrupt
// bitstream or 2 for an unsupported one (the reason is written to err).
//   metrabs_webp_vp8_tools(data, size, out, err, n)
// writes the 8 tool fields of a VP8 frame header (LossyDecoder::tools).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  int code;  // 1 corrupt, 2 unsupported
  std::string message;
};

[[noreturn]] void corrupt(const std::string& message) { throw DecodeError{1, message}; }
[[noreturn]] void unsupported(const std::string& message) { throw DecodeError{2, message}; }

// kf_bmode_probs, indexed [top mode][left mode] in this file's mode order.
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// default_coeff_probs [type][band][context][node].
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

// coeff_update_probs [type][band][context][node].
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// dc_qlookup and ac_qlookup.
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// The VP8L distance map: (yoffset << 4) | (8 - xoffset) of the 120 nearest
// neighbours.
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};
// ---------------------------------------------------------------------------
// VP8L

// LSB-first bit reader. Reading past the end gives zeros and marks the
// stream as overrun, which the decoder reports as corrupt (libwebp's eos_).
class LsbReader {
 public:
  LsbReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  uint32_t peek(int n) {
    fill();
    return static_cast<uint32_t>(window_ & ((uint64_t{1} << n) - 1));
  }
  void skip(int n) {
    window_ >>= n;
    avail_ -= n;
    consumed_ += n;
    if (consumed_ > 8 * size_) overrun = true;
  }
  uint32_t bits(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }

  bool overrun = false;

 private:
  void fill() {
    while (avail_ <= 56) {
      uint64_t byte = pos_ < size_ ? data_[pos_] : 0;
      pos_++;
      window_ |= byte << avail_;
      avail_ += 8;
    }
  }
  const uint8_t* data_;
  size_t size_, pos_ = 0;
  uint64_t window_ = 0;
  int avail_ = 0;
  size_t consumed_ = 0;
};

// A canonical prefix code. Codes are read bit by bit from the first bit of
// the code (DEFLATE's convention); an 8-bit root table decodes the short
// codes at once. A code with a single symbol takes no bits.
class PrefixCode {
 public:
  static const int kRoot = 8;

  // Builds the code from `lengths[0..n)`; false for an over- or
  // under-subscribed code (libwebp's VP8LBuildHuffmanTable).
  bool build(const int* lengths, int n) {
    int count[16] = {0};
    int used = 0, last = 0;
    for (int s = 0; s < n; s++) {
      if (lengths[s] > 15) return false;
      if (lengths[s]) {
        count[lengths[s]]++;
        used++;
        last = s;
      }
    }
    root_.assign(1 << kRoot, 0);
    if (used == 1) {  // one symbol: no bits
      single_ = true;
      single_symbol_ = last;
      return true;
    }
    single_ = false;
    int left = 1;
    for (int len = 1; len <= 15; len++) {
      left <<= 1;
      left -= count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;  // incomplete (also no symbol at all)
    std::copy(count, count + 16, count_);
    int offsets[16];
    offsets[1] = 0;
    for (int len = 1; len < 15; len++) offsets[len + 1] = offsets[len] + count[len];
    sorted_.assign(used, 0);
    for (int s = 0; s < n; s++) {
      if (lengths[s]) sorted_[offsets[lengths[s]]++] = s;
    }
    // Root table: entry = (symbol << 4) | length for codes of at most kRoot
    // bits, indexed by the code's bits in reading order.
    int code = 0, k = 0;
    for (int len = 1; len <= 15; len++) {
      for (int i = 0; i < count[len]; i++, k++, code++) {
        if (len <= kRoot) {
          int rev = 0;
          for (int b = 0; b < len; b++) rev |= ((code >> (len - 1 - b)) & 1) << b;
          for (int fill = rev; fill < (1 << kRoot); fill += 1 << len) {
            root_[fill] = (sorted_[k] << 4) | len;
          }
        }
      }
      code <<= 1;
    }
    return true;
  }

  int read(LsbReader& br) const {
    if (single_) return single_symbol_;
    uint32_t e = root_[br.peek(kRoot)];
    if (e) {
      br.skip(static_cast<int>(e & 15));
      return static_cast<int>(e >> 4);
    }
    // A longer code: canonical decoding one bit at a time.
    uint32_t window = br.peek(15);
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; len++) {
      code |= (window >> (len - 1)) & 1;
      int n = count_[len];
      if (code - first < n) {
        br.skip(len);
        return sorted_[index + code - first];
      }
      index += n;
      first += n;
      first <<= 1;
      code <<= 1;
    }
    corrupt("bad prefix code");
  }

 private:
  bool single_ = false;
  int single_symbol_ = 0;
  int count_[16] = {0};
  std::vector<uint32_t> root_;
  std::vector<int> sorted_;
};

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int d = sub3(a >> 24, b >> 24, c >> 24) + sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) + sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int v = static_cast<int>((c0 >> s) & 0xff) + static_cast<int>((c1 >> s) & 0xff) -
            static_cast<int>((c2 >> s) & 0xff);
    out |= clip255(static_cast<uint32_t>(v)) << s;
  }
  return out;
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = static_cast<int>((c0 >> s) & 0xff), b = static_cast<int>((c2 >> s) & 0xff);
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return out;
}

// Predictor `mode` for the pixel at `out` (left out[-1]) with the row above
// at `top` (top[-1] above-left, top[1] above-right).
inline uint32_t predict(int mode, const uint32_t* out, const uint32_t* top) {
  const uint32_t L = out[-1], T = top[0], TL = top[-1], TR = top[1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamped_add_subtract_full(L, T, TL);
    case 13: return clamped_add_subtract_half(average2(L, T), TL);
    default: return 0xff000000u;  // 0, 14 and 15
  }
}

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

struct HtreeGroup {
  PrefixCode codes[5];
};

class LosslessDecoder {
 public:
  LosslessDecoder(const uint8_t* data, size_t size) : br_(data, size) {}

  void decode(uint8_t* out, int expect_w, int expect_h) {
    if (br_.bits(8) != 0x2f) corrupt("bad VP8L signature");
    width_ = static_cast<int>(br_.bits(14)) + 1;
    height_ = static_cast<int>(br_.bits(14)) + 1;
    br_.bits(1);  // alpha_is_used
    if (br_.bits(3) != 0) corrupt("bad VP8L version");
    if (width_ != expect_w || height_ != expect_h) corrupt("VP8L size differs from the header's");
    std::vector<uint32_t> argb;
    decode_image_stream(width_, height_, true, argb);
    for (size_t i = 0, n = static_cast<size_t>(width_) * height_; i < n; i++) {
      out[3 * i] = static_cast<uint8_t>(argb[i] >> 16);
      out[3 * i + 1] = static_cast<uint8_t>(argb[i] >> 8);
      out[3 * i + 2] = static_cast<uint8_t>(argb[i]);
    }
  }

 private:
  void decode_image_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>& out) {
    int transform_xsize = xsize;
    if (level0) {
      while (br_.bits(1)) read_transform(transform_xsize, ysize);
    }
    int cache_bits = 0;
    if (br_.bits(1)) {
      cache_bits = static_cast<int>(br_.bits(4));
      if (cache_bits < 1 || cache_bits > 11) corrupt("bad colour cache size");
    }
    // Prefix codes, with meta codes at level 0 only.
    int meta_bits = 0, meta_xsize = 0;
    std::vector<uint32_t> meta;
    int n_groups = 1;
    if (level0 && br_.bits(1)) {
      meta_bits = static_cast<int>(br_.bits(3)) + 2;
      meta_xsize = subsample(transform_xsize, meta_bits);
      decode_image_stream(meta_xsize, subsample(ysize, meta_bits), false, meta);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        n_groups = std::max(n_groups, static_cast<int>(m) + 1);
      }
    }
    if (br_.overrun) corrupt("truncated VP8L stream");
    std::vector<HtreeGroup> groups(n_groups);
    std::vector<int> lengths;
    for (HtreeGroup& g : groups) {
      for (int j = 0; j < 5; j++) {
        int alphabet = kAlphabetSize[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
        read_code(alphabet, lengths, g.codes[j]);
      }
    }
    out.assign(static_cast<size_t>(transform_xsize) * ysize, 0);
    decode_pixels(out, transform_xsize, ysize, groups, meta, meta_bits, meta_xsize, cache_bits);
    if (level0) {
      for (int t = static_cast<int>(transforms_.size()) - 1; t >= 0; t--) {
        inverse_transform(transforms_[t], out, ysize);
      }
    }
  }

  void read_transform(int& xsize, int ysize) {
    int type = static_cast<int>(br_.bits(2));
    if (seen_ & (1 << type)) corrupt("VP8L transform repeated");
    seen_ |= 1 << type;
    Transform t{type, 0, xsize, {}};
    if (type == 0 || type == 1) {  // predictor, cross-colour
      t.bits = static_cast<int>(br_.bits(3)) + 2;
      decode_image_stream(subsample(xsize, t.bits), subsample(ysize, t.bits), false, t.data);
    } else if (type == 3) {  // colour indexing
      int n_colors = static_cast<int>(br_.bits(8)) + 1;
      t.bits = n_colors > 16 ? 0 : n_colors > 4 ? 1 : n_colors > 2 ? 2 : 3;
      xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> colors;
      decode_image_stream(n_colors, 1, false, colors);
      // The palette is delta-coded byte by byte; entries past it are 0.
      t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
      t.data[0] = colors[0];
      for (int i = 1; i < n_colors && i < static_cast<int>(t.data.size()); i++) {
        t.data[i] = add_pixels(colors[i], t.data[i - 1]);
      }
    }
    transforms_.push_back(std::move(t));
  }

  void read_code(int alphabet, std::vector<int>& lengths, PrefixCode& code) {
    lengths.assign(std::max(alphabet, 256), 0);
    if (br_.bits(1)) {  // simple code: one or two symbols
      int n_symbols = static_cast<int>(br_.bits(1)) + 1;
      int first_8bit = static_cast<int>(br_.bits(1));
      lengths[br_.bits(first_8bit ? 8 : 1)] = 1;
      if (n_symbols == 2) lengths[br_.bits(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      int n_codes = static_cast<int>(br_.bits(4)) + 4;
      for (int i = 0; i < n_codes; i++) cl_lengths[kCodeLengthCodeOrder[i]] = static_cast<int>(br_.bits(3));
      PrefixCode cl;
      if (!cl.build(cl_lengths, 19)) corrupt("bad code-length code");
      int max_symbol = alphabet;
      if (br_.bits(1)) {
        int length_bits = 2 + 2 * static_cast<int>(br_.bits(3));
        max_symbol = 2 + static_cast<int>(br_.bits(length_bits));
        if (max_symbol > alphabet) corrupt("bad code length count");
      }
      int prev = 8, symbol = 0;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        int len = cl.read(br_);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len) prev = len;
        } else {
          static const int kExtraBits[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          int slot = len - 16;
          int repeat = static_cast<int>(br_.bits(kExtraBits[slot])) + kOffset[slot];
          if (symbol + repeat > alphabet) corrupt("bad code length repeat");
          int value = len == 16 ? prev : 0;
          while (repeat-- > 0) lengths[symbol++] = value;
        }
        if (br_.overrun) corrupt("truncated VP8L stream");
      }
    }
    if (br_.overrun || !code.build(lengths.data(), alphabet)) corrupt("bad prefix code");
  }

  void decode_pixels(std::vector<uint32_t>& data, int width, int height, const std::vector<HtreeGroup>& groups,
                     const std::vector<uint32_t>& meta, int meta_bits, int meta_xsize, int cache_bits) {
    std::vector<uint32_t> cache(cache_bits ? size_t{1} << cache_bits : 0);
    const size_t total = data.size();
    size_t pos = 0, cached = 0;
    int col = 0, row = 0;
    auto group_at = [&](int x, int y) -> const HtreeGroup& {
      if (meta_bits == 0) return groups[0];
      return groups[meta[static_cast<size_t>(y >> meta_bits) * meta_xsize + (x >> meta_bits)]];
    };
    auto insert_cached = [&]() {
      if (!cache_bits) return;
      for (; cached < pos; cached++) {
        cache[(0x1e35a7bdu * data[cached]) >> (32 - cache_bits)] = data[cached];
      }
    };
    while (pos < total) {
      const HtreeGroup& g = group_at(col, row);
      int code = g.codes[0].read(br_);
      if (code < 256) {
        uint32_t red = static_cast<uint32_t>(g.codes[1].read(br_));
        uint32_t blue = static_cast<uint32_t>(g.codes[2].read(br_));
        uint32_t alpha = static_cast<uint32_t>(g.codes[3].read(br_));
        data[pos++] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
        if (++col >= width) {
          col = 0;
          row++;
        }
      } else if (code < 256 + 24) {
        int length = copy_distance(code - 256);
        int dist_symbol = g.codes[4].read(br_);
        int dist = plane_code_to_distance(width, copy_distance(dist_symbol));
        if (br_.overrun) corrupt("truncated VP8L stream");
        if (pos < static_cast<size_t>(dist) || total - pos < static_cast<size_t>(length)) {
          corrupt("bad backward reference");
        }
        for (int i = 0; i < length; i++, pos++) data[pos] = data[pos - dist];
        col += length;
        while (col >= width) {
          col -= width;
          row++;
        }
      } else {
        int key = code - (256 + 24);
        if (key >= static_cast<int>(cache.size())) corrupt("bad colour cache key");
        insert_cached();
        data[pos++] = cache[key];
        if (++col >= width) {
          col = 0;
          row++;
        }
      }
      if (br_.overrun) corrupt("truncated VP8L stream");
      insert_cached();
    }
  }

  int copy_distance(int symbol) {
    if (symbol < 4) return symbol + 1;
    int extra = (symbol - 2) >> 1;
    int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br_.bits(extra)) + 1;
  }

  static int plane_code_to_distance(int xsize, int plane_code) {
    if (plane_code > 120) return plane_code - 120;
    int dist_code = kCodeToPlane[plane_code - 1];
    int dist = (dist_code >> 4) * xsize + 8 - (dist_code & 0xf);
    return dist >= 1 ? dist : 1;
  }

  // Undoes one transform; `data` holds the image at the transform's output
  // width (xsize) or, for colour indexing, at its packed width.
  void inverse_transform(const Transform& t, std::vector<uint32_t>& data, int height) {
    const int width = t.xsize;
    switch (t.type) {
      case 0: {  // predictor
        std::vector<uint32_t> out(static_cast<size_t>(width) * height + 1);
        const int tiles = subsample(width, t.bits);
        for (int y = 0; y < height; y++) {
          uint32_t* o = out.data() + static_cast<size_t>(y) * width;
          const uint32_t* in = data.data() + static_cast<size_t>(y) * width;
          const uint32_t* top = o - width;
          for (int x = 0; x < width; x++) {
            uint32_t pred;
            if (y == 0) pred = x == 0 ? 0xff000000u : o[x - 1];
            else if (x == 0) pred = top[0];
            else pred = predict((t.data[static_cast<size_t>(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 0xf,
                                o + x, top + x);
            o[x] = add_pixels(in[x], pred);
          }
        }
        out.pop_back();
        data.swap(out);
        break;
      }
      case 1: {  // cross-colour
        const int tiles = subsample(width, t.bits);
        for (int y = 0; y < height; y++) {
          uint32_t* p = data.data() + static_cast<size_t>(y) * width;
          for (int x = 0; x < width; x++) {
            uint32_t code = t.data[static_cast<size_t>(y >> t.bits) * tiles + (x >> t.bits)];
            int8_t g2r = static_cast<int8_t>(code & 0xff), g2b = static_cast<int8_t>((code >> 8) & 0xff);
            int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
            uint32_t argb = p[x];
            int8_t green = static_cast<int8_t>(argb >> 8);
            int red = static_cast<int>((argb >> 16) & 0xff), blue = static_cast<int>(argb & 0xff);
            red = (red + ((static_cast<int>(g2r) * green) >> 5)) & 0xff;
            blue += (static_cast<int>(g2b) * green) >> 5;
            blue += (static_cast<int>(r2b) * static_cast<int8_t>(red)) >> 5;
            blue &= 0xff;
            p[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
          }
        }
        break;
      }
      case 2:  // subtract green
        for (uint32_t& p : data) {
          uint32_t green = (p >> 8) & 0xff;
          uint32_t rb = ((p & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
          p = (p & 0xff00ff00u) | rb;
        }
        break;
      case 3: {  // colour indexing
        std::vector<uint32_t> out(static_cast<size_t>(width) * height);
        const int packed_w = subsample(width, t.bits);
        const int bits_per_pixel = 8 >> t.bits, per_byte_mask = (1 << t.bits) - 1;
        const uint32_t index_mask = (1u << bits_per_pixel) - 1;
        for (int y = 0; y < height; y++) {
          const uint32_t* in = data.data() + static_cast<size_t>(y) * packed_w;
          uint32_t* o = out.data() + static_cast<size_t>(y) * width;
          uint32_t packed = 0;
          for (int x = 0; x < width; x++) {
            if ((x & per_byte_mask) == 0) packed = (*in++ >> 8) & 0xff;
            o[x] = t.data[packed & index_mask];
            packed >>= bits_per_pixel;
          }
        }
        data.swap(out);
        break;
      }
    }
  }

  LsbReader br_;
  int width_ = 0, height_ = 0;
  int seen_ = 0;
  std::vector<Transform> transforms_;
};

// ---------------------------------------------------------------------------
// VP8

// The boolean decoder as libwebp's VP8BitReader runs it: `range_` holds the
// range minus one, bytes are loaded as needed, and reading past the end
// shifts in zeros once and marks the reader (eof).
class BoolReader {
 public:
  BoolReader() = default;
  BoolReader(const uint8_t* data, size_t size) : buf_(data), end_(data + size) { load(); }

  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int b = value > split;
    if (b) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      range = split + 1;
    }
    int shift = 7 ^ floor_log2(range);
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return b;
  }

  int value(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }

  int signed_value(int n) {
    int v = value(n);
    return bit(0x80) ? -v : v;
  }

  // libwebp's VP8GetSigned: a sign read with one bit of renormalisation.
  int apply_sign(int v) {
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = range_ >> 1;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int32_t mask = static_cast<int32_t>(split - value) >> 31;  // -1 when value > split
    bits_ -= 1;
    range_ = (range_ + static_cast<uint32_t>(mask)) | 1;
    value_ -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }

  bool eof = false;

 private:
  static int floor_log2(uint32_t v) {
    int n = 0;
    while (v >>= 1) n++;
    return n;
  }

  void load() {
    while (bits_ < 0) {
      if (buf_ < end_) {
        value_ = (value_ << 8) | *buf_++;
        bits_ += 8;
      } else if (!eof) {
        value_ <<= 8;
        bits_ += 8;
        eof = true;
      } else {
        bits_ = 0;
      }
    }
  }

  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 255 - 1;
  int bits_ = -8;
};

// Intra modes, in libwebp's order (which indexes kBModesProba).
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED,
       B_HU_PRED };
const int kYModesIntra4[18] = {-B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
                               -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};
const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct MacroBlock {
  int segment = 0, is_i4x4 = 0, skip = 0;
  uint8_t imodes[16] = {0};
  int uvmode = 0;
  int16_t coeffs[384];
};

// Context of the non-zero flags: bits 0-3 luma columns (or rows), 4-5 U,
// 6-7 V; nz_dc the Y2 block's.
struct NzContext {
  uint8_t nz = 0, nz_dc = 0;
};

struct FilterInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

const int BPS = 32;  // the work buffer's stride, as libwebp's

// Loop-filter primitives (RFC 6386 section 15; libwebp's dsp/dec.c).
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; i++, p += vstride) {
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
  }
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh,
                 bool edge) {
  const int thresh2 = 2 * thresh + 1;
  for (; size > 0; size--, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
    else if (edge) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// The 4x4 predictors on the work buffer (dst[-BPS] above, dst[-1] left).
void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  auto at = [&](int x, int y) -> uint8_t& { return dst[x + y * BPS]; };
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; i++) dc += top[i] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int y = 0; y < 4; y++) std::memset(dst + y * BPS, dc, 4);
      break;
    }
    case B_TM_PRED:
      for (int y = 0; y < 4; y++) {
        for (int x = 0; x < 4; x++) at(x, y) = clip8(top[x] + dst[-1 + y * BPS] - X);
      }
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {static_cast<uint8_t>(avg3(X, A, B)), static_cast<uint8_t>(avg3(A, B, C)),
                               static_cast<uint8_t>(avg3(B, C, D)), static_cast<uint8_t>(avg3(C, D, E))};
      for (int y = 0; y < 4; y++) std::memcpy(dst + y * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int rows[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; y++) std::memset(dst + y * BPS, rows[y], 4);
      break;
    }
    case B_RD_PRED:
      at(0, 3) = avg3(J, K, L);
      at(1, 3) = at(0, 2) = avg3(I, J, K);
      at(2, 3) = at(1, 2) = at(0, 1) = avg3(X, I, J);
      at(3, 3) = at(2, 2) = at(1, 1) = at(0, 0) = avg3(A, X, I);
      at(3, 2) = at(2, 1) = at(1, 0) = avg3(B, A, X);
      at(3, 1) = at(2, 0) = avg3(C, B, A);
      at(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      at(0, 0) = avg3(A, B, C);
      at(1, 0) = at(0, 1) = avg3(B, C, D);
      at(2, 0) = at(1, 1) = at(0, 2) = avg3(C, D, E);
      at(3, 0) = at(2, 1) = at(1, 2) = at(0, 3) = avg3(D, E, F);
      at(3, 1) = at(2, 2) = at(1, 3) = avg3(E, F, G);
      at(3, 2) = at(2, 3) = avg3(F, G, H);
      at(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      at(0, 0) = at(1, 2) = avg2(X, A);
      at(1, 0) = at(2, 2) = avg2(A, B);
      at(2, 0) = at(3, 2) = avg2(B, C);
      at(3, 0) = avg2(C, D);
      at(0, 3) = avg3(K, J, I);
      at(0, 2) = avg3(J, I, X);
      at(0, 1) = at(1, 3) = avg3(I, X, A);
      at(1, 1) = at(2, 3) = avg3(X, A, B);
      at(2, 1) = at(3, 3) = avg3(A, B, C);
      at(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      at(0, 0) = avg2(A, B);
      at(1, 0) = at(0, 2) = avg2(B, C);
      at(2, 0) = at(1, 2) = avg2(C, D);
      at(3, 0) = at(2, 2) = avg2(D, E);
      at(0, 1) = avg3(A, B, C);
      at(1, 1) = at(0, 3) = avg3(B, C, D);
      at(2, 1) = at(1, 3) = avg3(C, D, E);
      at(3, 1) = at(2, 3) = avg3(D, E, F);
      at(3, 2) = avg3(E, F, G);
      at(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      at(0, 0) = at(2, 1) = avg2(I, X);
      at(0, 1) = at(2, 2) = avg2(J, I);
      at(0, 2) = at(2, 3) = avg2(K, J);
      at(0, 3) = avg2(L, K);
      at(3, 0) = avg3(A, B, C);
      at(2, 0) = avg3(X, A, B);
      at(1, 0) = at(3, 1) = avg3(I, X, A);
      at(1, 1) = at(3, 2) = avg3(J, I, X);
      at(1, 2) = at(3, 3) = avg3(K, J, I);
      at(1, 3) = avg3(L, K, J);
      break;
    case B_HU_PRED:
      at(0, 0) = avg2(I, J);
      at(2, 0) = at(0, 1) = avg2(J, K);
      at(2, 1) = at(0, 2) = avg2(K, L);
      at(1, 0) = avg3(I, J, K);
      at(3, 0) = at(1, 1) = avg3(J, K, L);
      at(3, 1) = at(1, 2) = avg3(K, L, L);
      at(3, 2) = at(2, 2) = at(0, 3) = at(1, 3) = at(2, 3) = at(3, 3) = L;
      break;
  }
}

// 16x16 and chroma 8x8 prediction of `size` (DC with its edge variants,
// TM, V, H).
void predict_block(int mode, uint8_t* dst, int size, bool has_top, bool has_left) {
  const uint8_t* top = dst - BPS;
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC_PRED: {
      int dc;
      if (has_top && has_left) {
        dc = size;
        for (int i = 0; i < size; i++) dc += top[i] + dst[-1 + i * BPS];
        dc >>= shift + 1;
      } else if (has_top) {
        dc = size >> 1;
        for (int i = 0; i < size; i++) dc += top[i];
        dc >>= shift;
      } else if (has_left) {
        dc = size >> 1;
        for (int i = 0; i < size; i++) dc += dst[-1 + i * BPS];
        dc >>= shift;
      } else {
        dc = 0x80;
      }
      for (int y = 0; y < size; y++) std::memset(dst + y * BPS, dc, size);
      break;
    }
    case B_TM_PRED:
      for (int y = 0; y < size; y++) {
        for (int x = 0; x < size; x++) dst[x + y * BPS] = clip8(top[x] + dst[-1 + y * BPS] - top[-1]);
      }
      break;
    case B_VE_PRED:
      for (int y = 0; y < size; y++) std::memcpy(dst + y * BPS, top, size);
      break;
    case B_HE_PRED:
      for (int y = 0; y < size; y++) std::memset(dst + y * BPS, dst[-1 + y * BPS], size);
      break;
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The inverse DCT of one 4x4 block, added to `dst` (libwebp's
// TransformOne; its DC-only and AC3 variants give the same numbers).
void inverse_dct_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * BPS;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

// The inverse Walsh-Hadamard transform of the Y2 block into the DC of the
// 16 luma blocks.
void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// libwebp's YUV to RGB (yuv.h): 14-bit coefficients, results in 6 extra bits.
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return (v & ~16383) == 0 ? static_cast<uint8_t>(v >> 6) : v < 0 ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

class LossyDecoder {
 public:
  LossyDecoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  // The frame header's tools: filter type (0 none, 1 simple, 2 normal),
  // level, sharpness, token partitions, segmentation, segment map update,
  // loop-filter deltas, skip probability.
  void tools(int* out) {
    parse_headers();
    const int values[8] = {filter_type_, level_, sharpness_, static_cast<int>(parts_.size()),
                           use_segment_, update_map_, use_lf_delta_, use_skip_proba_};
    std::copy(values, values + 8, out);
  }

  void decode(uint8_t* out, int expect_w, int expect_h) {
    parse_headers();
    if (width_ != expect_w || height_ != expect_h) corrupt("VP8 size differs from the header's");
    reconstruct();
    if (filter_type_ > 0) loop_filter();
    upsample_to_rgb(out);
  }

 private:
  void parse_headers() {
    if (size_ < 10) corrupt("truncated VP8 frame header");
    const uint32_t bits = data_[0] | (data_[1] << 8) | (data_[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (!key_frame) unsupported("VP8 inter frame");
    if (profile > 3) corrupt("bad VP8 profile");
    if (!show) unsupported("VP8 frame not displayable");
    if (data_[3] != 0x9d || data_[4] != 0x01 || data_[5] != 0x2a) corrupt("bad VP8 start code");
    width_ = (data_[6] | (data_[7] << 8)) & 0x3fff;
    height_ = (data_[8] | (data_[9] << 8)) & 0x3fff;
    if (width_ == 0 || height_ == 0) corrupt("empty VP8 frame");
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    const uint8_t* buf = data_ + 10;
    size_t left = size_ - 10;
    if (partition_length > left) corrupt("bad VP8 partition length");
    br_ = BoolReader(buf, partition_length);
    buf += partition_length;
    left -= partition_length;
    br_.value(1);  // colour space
    br_.value(1);  // clamping type
    // Segment header.
    use_segment_ = br_.value(1);
    if (use_segment_) {
      update_map_ = br_.value(1);
      if (br_.value(1)) {  // update data
        // libwebp's encoder writes absolute values; libvpx's relative ones,
        // which nothing here writes.
        if (!br_.value(1)) unsupported("VP8 segment values relative to the frame's");
        for (int s = 0; s < 4; s++) quantizer_[s] = br_.value(1) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; s++) filter_strength_[s] = br_.value(1) ? br_.signed_value(6) : 0;
      }
      if (update_map_) {
        for (int s = 0; s < 3; s++) segment_proba_[s] = br_.value(1) ? br_.value(8) : 255;
      }
    }
    // Filter header.
    simple_ = br_.value(1);
    level_ = br_.value(6);
    sharpness_ = br_.value(3);
    use_lf_delta_ = br_.value(1);
    if (use_lf_delta_ && br_.value(1)) {
      // Non-zero deltas are libvpx's (libwebp's encoder writes none).
      for (int i = 0; i < 8; i++) {
        if (br_.value(1) && br_.signed_value(6) != 0) unsupported("VP8 loop-filter deltas");
      }
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    // Token partitions.
    const int last = (1 << br_.value(2)) - 1;
    if (left < static_cast<size_t>(3 * last)) corrupt("truncated VP8 partitions");
    const uint8_t* sizes = buf;
    const uint8_t* part = buf + 3 * last;
    size_t part_left = left - 3 * last;
    parts_.clear();
    for (int p = 0; p < last; p++) {
      size_t psize = sizes[0] | (sizes[1] << 8) | (sizes[2] << 16);
      if (psize > part_left) psize = part_left;
      parts_.emplace_back(part, psize);
      part += psize;
      part_left -= psize;
      sizes += 3;
    }
    if (part_left == 0) corrupt("truncated VP8 partitions");
    parts_.emplace_back(part, part_left);
    // Quantisers.
    const int base_q = br_.value(7);
    const int dqy1_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy2_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy2_ac = br_.value(1) ? br_.signed_value(4) : 0;
    const int dquv_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dquv_ac = br_.value(1) ? br_.signed_value(4) : 0;
    for (int s = 0; s < 4; s++) {
      int q;
      if (use_segment_) {
        q = quantizer_[s];
      } else if (s > 0) {
        dqm_[s] = dqm_[0];
        continue;
      } else {
        q = base_q;
      }
      QuantMatrix& m = dqm_[s];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br_.value(1);  // refresh entropy probabilities: ignored on a key frame
    for (int t = 0; t < 4; t++) {
      for (int b = 0; b < 8; b++) {
        for (int c = 0; c < 3; c++) {
          for (int p = 0; p < 11; p++) {
            proba_[t][b][c][p] = static_cast<uint8_t>(
                br_.bit(kCoeffsUpdateProba[t][b][c][p]) ? br_.value(8) : kCoeffsProba0[t][b][c][p]);
          }
        }
      }
    }
    use_skip_proba_ = br_.value(1);
    if (use_skip_proba_) skip_p_ = br_.value(8);
    precompute_filter_strengths();
  }

  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; s++) {
      for (int i4x4 = 0; i4x4 <= 1; i4x4++) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = use_segment_ ? filter_strength_[s] : level_;
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(MacroBlock& mb, uint8_t* top, uint8_t* left) {
    if (update_map_) {
      mb.segment = !br_.bit(segment_proba_[0]) ? br_.bit(segment_proba_[1]) : br_.bit(segment_proba_[2]) + 2;
    } else {
      mb.segment = 0;
    }
    mb.skip = use_skip_proba_ ? br_.bit(skip_p_) : 0;
    mb.is_i4x4 = !br_.bit(145);
    if (!mb.is_i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? B_TM_PRED : B_HE_PRED)
                                     : (br_.bit(163) ? B_VE_PRED : B_DC_PRED);
      mb.imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = mb.imodes;
      for (int y = 0; y < 4; y++) {
        int ymode = left[y];
        for (int x = 0; x < 4; x++) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br_.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
          ymode = -i;
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    mb.uvmode = !br_.bit(142) ? B_DC_PRED : !br_.bit(114) ? B_VE_PRED : br_.bit(183) ? B_TM_PRED : B_HE_PRED;
  }

  int large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.bit(p[3])) {
      v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // libwebp's GetCoeffs: the index past the last non-zero coefficient.
  int coeffs(BoolReader& br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = proba_[type][kBands[n + 1]][1];
      } else {
        v = large_value(br, p);
        p = proba_[type][kBands[n + 1]][2];
      }
      out[kZigzag[n]] = static_cast<int16_t>(br.apply_sign(v) * dq[n > 0]);
    }
    return 16;
  }

  // Returns whether every coefficient is zero.
  bool parse_residuals(MacroBlock& mb, NzContext& top, NzContext& left, BoolReader& br) {
    const QuantMatrix& q = dqm_[mb.segment];
    int16_t* dst = mb.coeffs;
    std::memset(dst, 0, sizeof(mb.coeffs));
    int first, ac_type;
    bool any = false;
    if (!mb.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = top.nz_dc + left.nz_dc;
      const int nz = coeffs(br, 1, ctx, q.y2, 0, dc);
      top.nz_dc = left.nz_dc = nz > 0;
      inverse_wht(dc, dst);
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = top.nz & 0x0f, lnz = left.nz & 0x0f;
    for (int y = 0; y < 4; y++) {
      int l = lnz & 1;
      for (int x = 0; x < 4; x++) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(br, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
        if (nz > 1 || dst[0] != 0) any = true;
        dst += 16;
      }
      tnz >>= 4;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t t = top.nz >> (4 + ch), lz = left.nz >> (4 + ch);
      for (int y = 0; y < 2; y++) {
        int l = lz & 1;
        for (int x = 0; x < 2; x++) {
          const int ctx = l + (t & 1);
          const int nz = coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          t = (t >> 1) | (l << 3);
          if (nz > 1 || dst[0] != 0) any = true;
          dst += 16;
        }
        t >>= 2;
        lz = (lz >> 1) | (l << 5);
      }
      out_t |= (t << 4) << ch;
      out_l |= (lz & 0xf0) << ch;
    }
    top.nz = static_cast<uint8_t>(out_t);
    left.nz = static_cast<uint8_t>(out_l);
    return !any;
  }

  void reconstruct() {
    const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
    y_.assign(static_cast<size_t>(yw) * mb_h_ * 16, 0);
    u_.assign(static_cast<size_t>(uvw) * mb_h_ * 8, 0);
    v_.assign(static_cast<size_t>(uvw) * mb_h_ * 8, 0);
    finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FilterInfo());
    std::vector<uint8_t> intra_t(4 * mb_w_, B_DC_PRED);
    std::vector<NzContext> nz_top(mb_w_);
    // The work buffer: luma at (1, 1) with 4 extra columns for the top
    // right, chroma below it.
    uint8_t work[BPS * 17 + BPS * 9 * 2];
    uint8_t* yb = work + BPS + 8;
    uint8_t* ub = work + BPS * 17 + BPS + 8;
    uint8_t* vb = ub + 8 + 8;
    MacroBlock mb;
    for (int mb_y = 0; mb_y < mb_h_; mb_y++) {
      BoolReader& tokens = parts_[mb_y & (parts_.size() - 1)];
      uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
      NzContext nz_left;
      for (int mb_x = 0; mb_x < mb_w_; mb_x++) {
        parse_intra_mode(mb, &intra_t[4 * mb_x], intra_l);
        if (br_.eof) corrupt("premature end of VP8 partition 0");
        bool skip = mb.skip;
        if (!skip) {
          skip = parse_residuals(mb, nz_top[mb_x], nz_left, tokens);
        } else {
          nz_left.nz = nz_top[mb_x].nz = 0;
          if (!mb.is_i4x4) nz_left.nz_dc = nz_top[mb_x].nz_dc = 0;
          std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
        }
        if (tokens.eof) corrupt("premature end of VP8 token partition");
        if (filter_type_ > 0) {
          FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
          f = fstrengths_[mb.segment][mb.is_i4x4];
          f.inner |= !skip;
        }
        reconstruct_mb(mb, mb_x, mb_y, yb, ub, vb);
      }
    }
  }

  // Loads the edge samples of macroblock (mb_x, mb_y) around the work
  // buffer's blocks as libwebp's ReconstructRow sets them, predicts, adds
  // the residuals and stores the unfiltered result into the planes.
  void reconstruct_mb(const MacroBlock& mb, int mb_x, int mb_y, uint8_t* yb, uint8_t* ub, uint8_t* vb) {
    const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
    uint8_t* yp = &y_[static_cast<size_t>(mb_y) * 16 * yw + mb_x * 16];
    uint8_t* up = &u_[static_cast<size_t>(mb_y) * 8 * uvw + mb_x * 8];
    uint8_t* vp = &v_[static_cast<size_t>(mb_y) * 8 * uvw + mb_x * 8];
    auto edges = [&](uint8_t* b, const uint8_t* plane, int stride, int size, bool top_right) {
      const int extra = top_right ? 4 : 0;
      if (mb_y > 0) {
        std::memcpy(b - BPS, plane - stride, size);
        b[-BPS - 1] = mb_x > 0 ? plane[-stride - 1] : 129;
        if (top_right) {
          if (mb_x < mb_w_ - 1) std::memcpy(b - BPS + 16, plane - stride + 16, 4);
          else std::memset(b - BPS + 16, plane[-stride + 15], 4);
        }
      } else {
        std::memset(b - BPS - 1, 127, size + extra + 1);
      }
      for (int j = 0; j < size; j++) b[j * BPS - 1] = mb_x > 0 ? plane[j * stride - 1] : 129;
    };
    edges(yb, yp, yw, 16, true);
    edges(ub, up, uvw, 8, false);
    edges(vb, vp, uvw, 8, false);
    const int16_t* coeffs = mb.coeffs;
    if (mb.is_i4x4) {
      uint8_t* top_right = yb - BPS + 16;
      for (int r = 1; r < 4; r++) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
      for (int n = 0; n < 16; n++) {
        uint8_t* dst = yb + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict4(mb.imodes[n], dst);
        inverse_dct_add(coeffs + n * 16, dst);
      }
    } else {
      predict_block(mb.imodes[0], yb, 16, mb_y > 0, mb_x > 0);
      for (int n = 0; n < 16; n++) {
        inverse_dct_add(coeffs + n * 16, yb + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
    }
    predict_block(mb.uvmode, ub, 8, mb_y > 0, mb_x > 0);
    predict_block(mb.uvmode, vb, 8, mb_y > 0, mb_x > 0);
    for (int n = 0; n < 4; n++) {
      inverse_dct_add(coeffs + 256 + n * 16, ub + (n & 1) * 4 + (n >> 1) * 4 * BPS);
      inverse_dct_add(coeffs + 320 + n * 16, vb + (n & 1) * 4 + (n >> 1) * 4 * BPS);
    }
    for (int j = 0; j < 16; j++) std::memcpy(yp + j * yw, yb + j * BPS, 16);
    for (int j = 0; j < 8; j++) {
      std::memcpy(up + j * uvw, ub + j * BPS, 8);
      std::memcpy(vp + j * uvw, vb + j * BPS, 8);
    }
  }

  // The loop filter over the whole frame in macroblock order (libwebp's
  // DoFilter per macroblock: left edge, inner vertical edges, top edge,
  // inner horizontal edges).
  void loop_filter() {
    const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
    for (int mb_y = 0; mb_y < mb_h_; mb_y++) {
      for (int mb_x = 0; mb_x < mb_w_; mb_x++) {
        const FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* y = &y_[static_cast<size_t>(mb_y) * 16 * yw + mb_x * 16];
        if (filter_type_ == 1) {
          if (mb_x > 0) simple_filter(y, 1, yw, limit + 4);
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) simple_filter(y + k, 1, yw, limit);
          }
          if (mb_y > 0) simple_filter(y, yw, 1, limit + 4);
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) simple_filter(y + k * yw, yw, 1, limit);
          }
          continue;
        }
        uint8_t* u = &u_[static_cast<size_t>(mb_y) * 8 * uvw + mb_x * 8];
        uint8_t* v = &v_[static_cast<size_t>(mb_y) * 8 * uvw + mb_x * 8];
        const int il = f.ilevel, hev_t = f.hev_thresh;
        if (mb_x > 0) {
          filter_loop(y, 1, yw, 16, limit + 4, il, hev_t, true);
          filter_loop(u, 1, uvw, 8, limit + 4, il, hev_t, true);
          filter_loop(v, 1, uvw, 8, limit + 4, il, hev_t, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) filter_loop(y + k, 1, yw, 16, limit, il, hev_t, false);
          filter_loop(u + 4, 1, uvw, 8, limit, il, hev_t, false);
          filter_loop(v + 4, 1, uvw, 8, limit, il, hev_t, false);
        }
        if (mb_y > 0) {
          filter_loop(y, yw, 1, 16, limit + 4, il, hev_t, true);
          filter_loop(u, uvw, 1, 8, limit + 4, il, hev_t, true);
          filter_loop(v, uvw, 1, 8, limit + 4, il, hev_t, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) filter_loop(y + k * yw, yw, 1, 16, limit, il, hev_t, false);
          filter_loop(u + 4 * uvw, uvw, 1, 8, limit, il, hev_t, false);
          filter_loop(v + 4 * uvw, uvw, 1, 8, limit, il, hev_t, false);
        }
      }
    }
  }

  // libwebp's fancy upsampler (UpsampleRgbLinePair) over the whole picture:
  // each output row takes 3/4 of its nearer chroma row and 1/4 of the other
  // (the first and, for an even height, the last row only their own), and
  // each pixel 3/4 of its nearer chroma column likewise.
  void upsample_to_rgb(uint8_t* out) {
    const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
    const int W = width_, H = height_;
    const int uv_w = (W + 1) / 2;
    std::vector<int> cu(uv_w), cv(uv_w);
    for (int r = 0; r < H; r++) {
      // near and far chroma rows
      int near, far;
      if (r == 0) {
        near = far = 0;
      } else if (r & 1) {
        near = (r - 1) >> 1;
        far = (r + 1) >> 1;
        if (r == H - 1) far = near;
      } else {
        near = r >> 1;
        far = near - 1;
      }
      const uint8_t* un = &u_[static_cast<size_t>(near) * uvw];
      const uint8_t* uf = &u_[static_cast<size_t>(far) * uvw];
      const uint8_t* vn = &v_[static_cast<size_t>(near) * uvw];
      const uint8_t* vf = &v_[static_cast<size_t>(far) * uvw];
      const uint8_t* yrow = &y_[static_cast<size_t>(r) * yw];
      uint8_t* o = out + static_cast<size_t>(r) * W * 3;
      // Vertically weighted chroma times 4 (libwebp keeps the packed sums).
      for (int x = 0; x < uv_w; x++) {
        cu[x] = 3 * un[x] + uf[x];
        cv[x] = 3 * vn[x] + vf[x];
      }
      // x = 0: the vertical mix alone.
      yuv_to_rgb(yrow[0], (cu[0] + 2) >> 2, (cv[0] + 2) >> 2, o);
      const int last_pair = (W - 1) >> 1;
      for (int x = 1; x <= last_pair; x++) {
        // tl/t (near row, columns x-1 and x) and l/c (far row) as in
        // libwebp, where "top" is the nearer chroma row.
        const int u_tl = un[x - 1], u_t = un[x], u_l = uf[x - 1], u_c = uf[x];
        const int v_tl = vn[x - 1], v_t = vn[x], v_l = vf[x - 1], v_c = vf[x];
        const int u_avg = u_tl + u_t + u_l + u_c + 8, v_avg = v_tl + v_t + v_l + v_c + 8;
        const int u_d12 = (u_avg + 2 * (u_t + u_l)) >> 3, u_d03 = (u_avg + 2 * (u_tl + u_c)) >> 3;
        const int v_d12 = (v_avg + 2 * (v_t + v_l)) >> 3, v_d03 = (v_avg + 2 * (v_tl + v_c)) >> 3;
        yuv_to_rgb(yrow[2 * x - 1], (u_d12 + u_tl) >> 1, (v_d12 + v_tl) >> 1, o + (2 * x - 1) * 3);
        yuv_to_rgb(yrow[2 * x], (u_d03 + u_t) >> 1, (v_d03 + v_t) >> 1, o + (2 * x) * 3);
      }
      if (!(W & 1)) {
        yuv_to_rgb(yrow[W - 1], (cu[uv_w - 1] + 2) >> 2, (cv[uv_w - 1] + 2) >> 2, o + (W - 1) * 3);
      }
    }
  }

  const uint8_t* data_;
  size_t size_;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolReader br_;
  std::vector<BoolReader> parts_;
  bool use_segment_ = false, update_map_ = false;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  int segment_proba_[3] = {255, 255, 255};
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  QuantMatrix dqm_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  FilterInfo fstrengths_[4][2];
  std::vector<FilterInfo> finfo_;
  std::vector<uint8_t> y_, u_, v_;
};

int report(const DecodeError& e, char* err, int err_len) {
  if (err && err_len > 0) std::snprintf(err, static_cast<size_t>(err_len), "%s", e.message.c_str());
  return e.code;
}

}  // namespace

extern "C" {

int metrabs_webp_decode(const uint8_t* data, size_t size, int lossless, int width, int height, uint8_t* out,
                        char* err, int err_len) {
  try {
    if (lossless) LosslessDecoder(data, size).decode(out, width, height);
    else LossyDecoder(data, size).decode(out, width, height);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(DecodeError{1, "out of memory"}, err, err_len);
  }
}

int metrabs_webp_vp8_tools(const uint8_t* data, size_t size, int* out, char* err, int err_len) {
  try {
    LossyDecoder(data, size).tools(out);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, err_len);
  }
}

}  // extern "C"
