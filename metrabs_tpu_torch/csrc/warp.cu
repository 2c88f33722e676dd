// Batched perspective crop warp from a 3-level box pyramid, for Hopper (sm_90a).
//
// Replaces the TPU kernel metrabs_tpu/ops/warp_pallas.py::_warp_tile_kernel
// (wrapper warp_images_with_pyramid_tiled). It computes the same function as
// the gather backend metrabs_tpu/ops/warp.py::warp_images_with_pyramid and
// its PyTorch twin metrabs_tpu_torch/ops/warp.py (warp_pyramid): per crop and
// output pixel, the ray new_invprojmat @ (x, y, 1) and its perspective
// divide, the 12-coefficient distortion (rational radial, tangential, thin
// prism), the source pixel through the level-adjusted intrinsics, +1 for the
// zero ring and a replicate-clamp to the padded level, then a bilinear
// sample of the 3-channel float pyramid. Output [N, oh, ow, 3] float32.
//
// What bounds it on the card: bytes. Each output pixel costs ~80 flops and
// writes 12 bytes; its 4 taps read 48 bytes, but neighbouring output pixels
// tap neighbouring source pixels, so device memory sees each source pixel of
// a crop's footprint about once (after level selection a footprint is at
// most ~2x the crop's output area). The output stores and that one pass are
// the bound. The taps are 4-byte loads that mostly hit L1, and their number
// rather than device memory is what the kernel waits on. The design:
// - each thread computes 4 output pixels of a row, 32 columns apart, so that
//   for each of them the warp's loads and stores cover 32 neighbouring
//   pixels (coalesced, few cache lines); it computes all 4 source positions
//   first, then issues its 48 tap loads (4 pixels x 4 taps x 3 channels)
//   together, then blends, so a warp keeps 1536 loads in flight;
// - a block is 32 x 8 threads covering 128 x 8 pixels of one crop; the
//   crop's 27 parameters and its level geometry are read once into
//   registers; the pyramid is pixel-major [T, 3] so a tap's channels share a
//   cache line; a ragged row end is masked.
// Four consecutive pixels per thread with 16-byte vector stores measured
// slower (scripts/torch_kernel_ab.py against that form: PERF.md): a warp's
// loads for one pixel then spread over 4x the cache lines. None of the TPU
// kernel's machinery carries over (the 104x256 DMA window, the double
// buffer, the hat-weight matmul, the tile meta table, the 128-column canvas
// alignment): it existed for the MXU and VMEM. Samples are never clamped to
// a window, so crops of scale <= 1/8 follow the gather semantics.
//
// Arithmetic is float32 in the plain version's order, term by term; the
// library is built with --fmad=false so that no multiply-add is contracted
// and the kernel rounds as the unfused PyTorch ops do. A NaN coordinate
// (degenerate homography) samples the level's corner, a zero-ring pixel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kRun = 4;       // output pixels per thread, kBlockX columns apart
constexpr int kNParams = 27;  // invproj (9), K rows 0-1 (6), distortion (12)
constexpr int kNGeom = 3;     // level pixel offset, padded height, padded width
constexpr int kChannels = 3;

struct Crop {
  float p[kNParams];
  int64_t base, hp, wp;
};

// The clamped source position (x, y) in the padded level of output pixel
// (xo, yo), in the plain version's operation order.
__device__ __forceinline__ void source_xy(const Crop& c, float xo, float yo, float& x, float& y) {
  const float* p = c.p;
  const float rx = p[0] * xo + p[1] * yo + p[2];
  const float ry = p[3] * xo + p[4] * yo + p[5];
  const float rz = p[6] * xo + p[7] * yo + p[8];
  const float px = rx / rz;
  const float py = ry / rz;

  const float* d = p + 15;
  const float r2 = px * px + py * py;
  const float a_num = ((d[4] * r2 + d[1]) * r2 + d[0]) * r2 + 1.0f;
  const float a_den = ((d[7] * r2 + d[6]) * r2 + d[5]) * r2 + 1.0f;
  const float a = a_num / a_den;
  const float b = 2.0f * (px * d[3] + py * d[2]);
  const float ab = a + b;
  const float xd = px * ab + ((d[9] * r2 + d[3]) + d[8]) * r2;
  const float yd = py * ab + ((d[11] * r2 + d[2]) + d[10]) * r2;

  const float xi = p[9] * xd + p[10] * yd + p[11];
  const float yi = p[12] * xd + p[13] * yd + p[14];
  // fmaxf returns the non-NaN operand: a NaN coordinate becomes 0.
  x = fminf(fmaxf(xi + 1.0f, 0.0f), (float)c.wp - 1.0f);
  y = fminf(fmaxf(yi + 1.0f, 0.0f), (float)c.hp - 1.0f);
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
warp_pyramid_kernel(const float* __restrict__ pyramid, int64_t n_pixels,
                    const float* __restrict__ params, const int64_t* __restrict__ geom,
                    float* __restrict__ out, int oh, int ow) {
  const int n = blockIdx.z;
  // Pixel j of this thread is column x0 + 32 j: a warp's loads and stores
  // for one j cover 32 neighbouring pixels.
  const int x0 = blockIdx.x * kBlockX * kRun + threadIdx.x;
  const int yo_i = blockIdx.y * kBlockY + threadIdx.y;
  if (x0 >= ow || yo_i >= oh) return;
  float* row = out + ((int64_t)n * oh + yo_i) * ow * kChannels;

  Crop c;
#pragma unroll
  for (int i = 0; i < kNParams; ++i) c.p[i] = __ldg(params + (int64_t)n * kNParams + i);
  c.base = __ldg(geom + (int64_t)n * kNGeom);
  c.hp = __ldg(geom + (int64_t)n * kNGeom + 1);
  c.wp = __ldg(geom + (int64_t)n * kNGeom + 2);
  if (c.base < 0 || c.hp < 2 || c.wp < 2 || c.base + c.hp * c.wp > n_pixels) {
    // Geometry outside the pyramid: flag it instead of reading out of bounds.
    for (int x = x0; x < ow && x < x0 + kBlockX * kRun; x += kBlockX)
      for (int ch = 0; ch < kChannels; ++ch) row[x * kChannels + ch] = __int_as_float(0x7fc00000);
    return;
  }

  // All source positions first, then every tap load, then the blends.
  float fx[kRun], fy[kRun];
  const float* t00[kRun];
  const float yo = (float)yo_i;
  const float wp2 = (float)c.wp - 2.0f;
  const float hp2 = (float)c.hp - 2.0f;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    float x, y;
    // Columns past the row end repeat x0: in bounds, never stored.
    const int xo = x0 + j * kBlockX < ow ? x0 + j * kBlockX : x0;
    source_xy(c, (float)xo, yo, x, y);
    const float xf = fminf(fmaxf(floorf(x), 0.0f), wp2);
    const float yf = fminf(fmaxf(floorf(y), 0.0f), hp2);
    fx[j] = x - xf;
    fy[j] = y - yf;
    t00[j] = pyramid + (c.base + (int64_t)yf * c.wp + (int64_t)xf) * kChannels;
  }
  float tap[kRun][4 * kChannels];  // top-left, top-right, bottom-left, bottom-right
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const float* t10 = t00[j] + c.wp * kChannels;
#pragma unroll
    for (int i = 0; i < 2 * kChannels; ++i) {
      tap[j][i] = __ldg(t00[j] + i);
      tap[j][2 * kChannels + i] = __ldg(t10 + i);
    }
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int xo = x0 + j * kBlockX;
    if (xo >= ow) break;
    const float gx = 1.0f - fx[j];
    const float gy = 1.0f - fy[j];
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch) {
      const float top = tap[j][ch] * gx + tap[j][kChannels + ch] * fx[j];
      const float bottom = tap[j][2 * kChannels + ch] * gx + tap[j][3 * kChannels + ch] * fx[j];
      row[xo * kChannels + ch] = top * gy + bottom * fy[j];
    }
  }
}

}  // namespace

// pyramid [n_pixels, 3] f32, params [n_crops, 27] f32, geom [n_crops, 3] i64,
// out [n_crops, oh, ow, 3] f32; all contiguous device memory. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int metrabs_warp_pyramid_f32(const float* pyramid, int64_t n_pixels,
                                        const float* params, const int64_t* geom,
                                        float* out, int n_crops, int oh, int ow,
                                        void* stream) {
  if (n_crops <= 0 || oh <= 0 || ow <= 0) return (int)cudaSuccess;
  const dim3 block(kBlockX, kBlockY);
  const int cols = kBlockX * kRun;
  const dim3 grid((ow + cols - 1) / cols, (oh + kBlockY - 1) / kBlockY, n_crops);
  warp_pyramid_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(pyramid, n_pixels, params, geom,
                                                                out, oh, ow);
  return (int)cudaGetLastError();
}
