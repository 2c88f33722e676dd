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
// What bounds it on the card: bytes. Each output pixel costs ~50 flops and
// writes 12 bytes, and its 4 taps read 48 bytes, but neighbouring output
// pixels tap neighbouring source pixels (a crop's source footprint is at most
// ~2x its output area after level selection), so the taps mostly hit L1/L2
// and the device-memory traffic is dominated by the output stores plus one
// pass over each crop's footprint. The design follows from that: one thread
// per output pixel, a block of 32x8 output pixels, so a warp covers 32
// consecutive pixels of one output row (its 12-byte stores coalesce into 384
// contiguous bytes and its taps fall on a few source rows); the pyramid is
// stored pixel-major [T, 3] so one tap's three channels share a cache line;
// the crop's 27 parameters and its level geometry are loaded once per block
// into shared memory. None of the TPU kernel's machinery carries over (the
// 104x256 DMA window, the double buffer, the hat-weight matmul, the tile
// meta table, the 128-column canvas alignment): it existed for the MXU and
// VMEM. Samples are never clamped to a window, so crops of scale <= 1/8
// follow the gather semantics.
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
constexpr int kNParams = 27;  // invproj (9), K rows 0-1 (6), distortion (12)
constexpr int kNGeom = 3;     // level pixel offset, padded height, padded width
constexpr int kChannels = 3;

__global__ void __launch_bounds__(kBlockX * kBlockY)
warp_pyramid_kernel(const float* __restrict__ pyramid, int64_t n_pixels,
                    const float* __restrict__ params,
                    const int64_t* __restrict__ geom,
                    float* __restrict__ out, int oh, int ow) {
  __shared__ float p[kNParams];
  __shared__ int64_t g[kNGeom];
  const int n = blockIdx.z;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  if (tid < kNParams) p[tid] = params[(int64_t)n * kNParams + tid];
  if (tid < kNGeom) g[tid] = geom[(int64_t)n * kNGeom + tid];
  __syncthreads();

  const int xo_i = blockIdx.x * kBlockX + threadIdx.x;
  const int yo_i = blockIdx.y * kBlockY + threadIdx.y;
  if (xo_i >= ow || yo_i >= oh) return;
  float* dst = out + (((int64_t)n * oh + yo_i) * ow + xo_i) * kChannels;

  const int64_t base = g[0];
  const int64_t hp = g[1];
  const int64_t wp = g[2];
  if (base < 0 || hp < 2 || wp < 2 || base + hp * wp > n_pixels) {
    // Geometry outside the pyramid: flag it instead of reading out of bounds.
    dst[0] = dst[1] = dst[2] = __int_as_float(0x7fc00000);
    return;
  }

  const float xo = (float)xo_i;
  const float yo = (float)yo_i;
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

  const float wpf = (float)wp;
  const float hpf = (float)hp;
  // fmaxf returns the non-NaN operand: a NaN coordinate becomes 0.
  const float x = fminf(fmaxf(xi + 1.0f, 0.0f), wpf - 1.0f);
  const float y = fminf(fmaxf(yi + 1.0f, 0.0f), hpf - 1.0f);
  const float x0 = fminf(fmaxf(floorf(x), 0.0f), wpf - 2.0f);
  const float y0 = fminf(fmaxf(floorf(y), 0.0f), hpf - 2.0f);
  const float fx = x - x0;
  const float fy = y - y0;
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;

  const float* t00 = pyramid + (base + (int64_t)y0 * wp + (int64_t)x0) * kChannels;
  const float* t10 = t00 + wp * kChannels;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    const float top = __ldg(t00 + c) * gx + __ldg(t00 + kChannels + c) * fx;
    const float bottom = __ldg(t10 + c) * gx + __ldg(t10 + kChannels + c) * fx;
    dst[c] = top * gy + bottom * fy;
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
  const dim3 grid((ow + kBlockX - 1) / kBlockX, (oh + kBlockY - 1) / kBlockY, n_crops);
  warp_pyramid_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      pyramid, n_pixels, params, geom, out, oh, ow);
  return (int)cudaGetLastError();
}
